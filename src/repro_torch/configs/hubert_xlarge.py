"""hubert-xlarge [audio]: encoder-only transformer (w2v2 arch); frame
frontend STUBBED with precomputed frame embeddings per brief
[arXiv:2106.07447; unverified].  48L d_model=1280 16H (kv=16, MHA,
d_head=80) d_ff=5120 vocab=504 (masked-prediction codebook).
Encoder-only => no decode shapes (skip noted in DESIGN.md)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
        n_heads=16, n_kv=16, d_head=80, d_ff=5120, vocab=504,
        causal=False, frontend="frame")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio", n_layers=3, d_model=64,
        n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=32, causal=False,
        frontend="frame", dtype="float32")

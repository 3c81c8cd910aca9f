"""pixtral-12b [vlm]: pixtral-ViT frontend (STUB: precomputed patch
embeddings per brief) + mistral-nemo-12b text backbone
[hf:mistralai/Pixtral-12B-2409; unverified].  40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv=8, d_head=128, d_ff=14336, vocab=131072,
        rope_theta=1_000_000.0, frontend="patch")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="vlm", n_layers=3, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
        frontend="patch", dtype="float32")

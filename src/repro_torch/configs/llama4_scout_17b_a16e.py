"""llama4-scout-17b-a16e [moe]: 16 routed experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  48L d_model=5120 40H
(kv=8, d_head=128) expert d_ff=8192 vocab=202048.  Early-fusion multimodal
frontend out of scope per brief (text backbone)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48,
        d_model=5120, n_heads=40, n_kv=8, d_head=128, d_ff=0,
        vocab=202048, moe_experts=16, moe_top_k=1, moe_d_ff=8192,
        moe_shared_expert=True, rope_theta=500_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=0, vocab=256, moe_experts=4,
        moe_top_k=1, moe_d_ff=96, moe_shared_expert=True, dtype="float32")

"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].  32L d_model=4096 32H (kv=8, d_head=128)
expert d_ff=14336 vocab=32000, SWA window 4096."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv=8, d_head=128, d_ff=0, vocab=32000,
        moe_experts=8, moe_top_k=2, moe_d_ff=14336, swa_window=4096,
        rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=0, vocab=256, moe_experts=4,
        moe_top_k=2, moe_d_ff=96, swa_window=16, dtype="float32")

"""yi-6b [dense]: llama-arch GQA [arXiv:2403.04652; hf].
32L d_model=4096 32H (kv=4, d_head=128) d_ff=11008 vocab=64000."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv=4, d_head=128, d_ff=11008, vocab=64000,
        rope_theta=5_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=96, vocab=256, dtype="float32")

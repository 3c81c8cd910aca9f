"""yi-34b [dense]: llama-arch GQA [arXiv:2403.04652; hf].
60L d_model=7168 56H (kv=8, d_head=128) d_ff=20480 vocab=64000."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv=8, d_head=128, d_ff=20480, vocab=64000,
        rope_theta=5_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=8, n_kv=2, d_head=8, d_ff=160, vocab=256, dtype="float32")

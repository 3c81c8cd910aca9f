"""qwen2-0.5b [dense]: GQA with QKV bias [arXiv:2407.10671; hf].
24L d_model=896 14H (kv=2, d_head=64) d_ff=4864 vocab=151936."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
        n_heads=14, n_kv=2, d_head=64, d_ff=4864, vocab=151936,
        qkv_bias=True, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256, qkv_bias=True,
        dtype="float32")

"""mistral-nemo-12b [dense]: 128k-context GQA
[hf:mistralai/Mistral-Nemo-Base-2407; hf].  40L d_model=5120 32H (kv=8,
d_head=128) d_ff=14336 vocab=131072."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv=8, d_head=128, d_ff=14336, vocab=131072,
        rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", family="dense", n_layers=3,
        d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
        dtype="float32")

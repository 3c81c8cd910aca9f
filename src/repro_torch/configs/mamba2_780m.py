"""mamba2-780m [ssm]: pure SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].  48L d_model=1536, d_inner=3072,
headdim=64 (48 ssm heads), d_state=128, vocab=50280."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
        n_heads=0, n_kv=0, d_head=0, d_ff=0, vocab=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=0, n_kv=0, d_head=0, d_ff=0, vocab=256,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        dtype="float32")

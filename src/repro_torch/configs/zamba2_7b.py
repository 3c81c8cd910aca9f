"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block every 6
layers [arXiv:2411.15242; unverified].  81L d_model=3584, GQA 32H kv=32
(MHA, d_head=112), d_ff=14336, vocab=32000, ssm_state=64.
Simplifications (documented, DESIGN.md): one shared block (no per-invocation
LoRA), shared-block input = concat(hidden, initial embedding)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv=32, d_head=112, d_ff=14336, vocab=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        attn_every=6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=256,
        ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        attn_every=2, dtype="float32")

"""The LM stack: configuration, layers, MoE, SSM, the model and its loss.

Counterpart of :mod:`repro.models` in PyTorch."""
from .config import ModelConfig
from .transformer import LM, lm_head_chunked, lm_loss

__all__ = ["ModelConfig", "LM", "lm_head_chunked", "lm_loss"]

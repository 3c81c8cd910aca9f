"""The LM stack's forward: configuration, layers, MoE, SSM and the model.

Counterpart of :mod:`repro.models` in PyTorch (serving half: no loss or
training step yet)."""
from .config import ModelConfig
from .transformer import LM

__all__ = ["ModelConfig", "LM"]

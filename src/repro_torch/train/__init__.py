"""The LM training stack: data, AdamW, the train step and checkpoints.

Counterpart of :mod:`repro.train` on one device; the reference's
``jit_train_step`` (its step jitted with mesh shardings) has no
counterpart."""
from .optimizer import OptConfig, adamw_update, init_opt_state, lr_at
from .train_step import make_train_step
from .data import DataConfig, TokenPipeline
from . import checkpoint

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "lr_at",
           "make_train_step", "DataConfig", "TokenPipeline", "checkpoint"]

"""Deterministic synthetic data pipeline (+ memmap file mode).

A copy of :mod:`repro.train.data` (NumPy only), kept here so that the port
imports nothing of the JAX package; the tests hold the two array for array.
Batches stay NumPy: the train step moves them to the model's device.

Step-addressable: ``batch_at(step)`` is a pure function of (seed, step), so a
restarted job resumes mid-stream with no state to recover — the data side
of fault tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None     # binary int32 token file (memmap mode)
    embed_dim: Optional[int] = None  # for frontend-stub archs


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.path is not None:
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        if self._mm is not None:
            need = c.global_batch * (c.seq_len + 1)
            start = (step * need) % max(len(self._mm) - need, 1)
            flat = np.asarray(self._mm[start:start + need])
            toks = flat.reshape(c.global_batch, c.seq_len + 1) % c.vocab
        else:
            rng = np.random.default_rng((c.seed << 32) ^ step)
            toks = rng.integers(0, c.vocab,
                                (c.global_batch, c.seq_len + 1),
                                dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.embed_dim is not None:
            rng = np.random.default_rng((c.seed << 32) ^ (step + 1 << 20))
            batch["embeds"] = rng.normal(
                size=(c.global_batch, c.seq_len, c.embed_dim)
            ).astype(np.float32)
            del batch["tokens"]
        return batch

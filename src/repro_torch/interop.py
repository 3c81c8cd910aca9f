"""Carry the reference's data across: layouts and vertex state.

For a graph system the layout and the vertex state play the part of
weights.  These helpers take the reference package's objects by duck typing
(their NumPy fields, or anything ``np.asarray`` reads, JAX arrays included)
and import nothing of it.  The reference's ``uint64`` packed
``min_with_payload`` state crosses as ``int64`` with the same bits (the
port's carrier, :func:`repro_torch.core.monoid.min_with_payload`), and
:func:`packed_to_numpy` turns it back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.engine import resolve_device
from .graph.layout import Layout

_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint32): torch.uint32, np.dtype(np.int64): torch.int64,
          np.dtype(np.bool_): torch.bool}


def layout_from_reference(layout) -> Layout:
    """A port :class:`Layout` with every field of ``layout`` (a
    ``repro.graph.layout.Layout``), arrays copied."""
    fields = {}
    for f in dataclasses.fields(Layout):
        v = getattr(layout, f.name)
        fields[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return Layout(**fields)


def to_torch(x, device="cuda") -> torch.Tensor:
    """One array (NumPy or JAX) as a tensor of the same dtype on ``device``
    (a CUDA device by default, which must exist; pass ``device="cpu"`` for
    the CPU); ``uint64`` as ``int64`` with the same bits."""
    dev = resolve_device(device)
    a = np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    if a.dtype not in _TORCH:
        raise TypeError(f"no tensor dtype for {a.dtype}")
    return torch.from_numpy(np.array(a)).to(dev)


def packed_to_numpy(t: torch.Tensor) -> np.ndarray:
    """An ``int64`` tensor of packed ``min_with_payload`` words as the
    reference's ``uint64`` NumPy array, bit for bit."""
    if t.dtype != torch.int64:
        raise TypeError(f"packed words are int64, not {t.dtype}")
    return t.cpu().numpy().view(np.uint64)


def state_to_torch(state: dict, device="cuda") -> dict:
    """A vertex-state dict of NumPy or JAX arrays as tensors on ``device``
    (as :func:`to_torch`); float32, int32, uint32, int64 and bool keep their
    types, and uint64 becomes int64 with the same bits."""
    dev = resolve_device(device)
    return {key: to_torch(v, dev) for key, v in state.items()}

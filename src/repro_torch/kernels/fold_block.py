"""Segmented monoid fold of a message stream — the gather of the SC stream.

Counterpart of :func:`repro.kernels.fold_block.blocked_segment_fold`: fold
``(vals, valid, ids)`` into ``acc[num_segments]`` and ``touched``.  Invalid
slots and ids outside ``[0, num_segments)`` contribute nothing.

Two versions of one function, chosen by the device of the tensors:

  * :func:`segment_fold`, the plain PyTorch version (CPU tensors; also the
    oracle that ``chip_smoke.py`` holds the kernel against on the card);
  * :func:`segment_fold_cuda`, the CUDA kernel ``csrc/segment_fold.cu``
    (CUDA tensors): one launch of a cooperative grid that fills the outputs
    and then folds, with each warp first combining runs of equal ids.  Up to
    40,960 segments (``kSharedMaxSegments<T>`` there; 22,752 for ``int64``)
    each block folds its slice of the stream in shared memory and merges
    the segments it touched with one global atomic each; past that it folds
    with global atomics.

The TPU kernel's 4096-segment cap is a limit of VMEM, so on this port the
same kernel folds any segment count and ``fold_tile`` is unused; the layout
keeps the field so that its arrays match the reference's.
"""
from __future__ import annotations

import os
import warnings

import torch

from ..core import monoid as M
from . import _build

DEFAULT_FOLD_TILE = 256
ENV_FOLD_TILE = "REPRO_FOLD_TILE"


def default_fold_tile() -> int:
    """``REPRO_FOLD_TILE`` if set, else the static default (layout field)."""
    env = os.environ.get(ENV_FOLD_TILE)
    return int(env) if env else DEFAULT_FOLD_TILE


def segment_fold(vals, valid, ids, num_segments: int, monoid: str = "add"):
    """Plain PyTorch segmented fold.  Returns ``(acc, touched)``.

    Invalid slots and out-of-range ids go to one extra scratch segment,
    dropped at the end, so the fold never syncs with the host."""
    ns = int(num_segments)
    dtype = vals.dtype
    ident = M.identity_value(monoid, dtype)
    ids = ids.to(torch.int64)
    keep = valid.to(torch.bool) & (ids >= 0) & (ids < ns)
    ids = torch.where(keep, ids, ns)
    wide = M.widen(vals)
    acc = torch.full((ns + 1,), ident, dtype=wide.dtype, device=vals.device)
    if monoid == "add":
        acc.index_add_(0, ids, wide)
    else:   # or folds as max, as in the reference
        with warnings.catch_warnings():   # "index_reduce() is in beta"
            warnings.simplefilter("ignore", UserWarning)
            acc.index_reduce_(0, ids, wide,
                              "amin" if M.FOLD[monoid] == "min"
                              else "amax",
                              include_self=True)
    touched = torch.zeros(ns + 1, dtype=torch.bool, device=vals.device)
    touched.index_fill_(0, ids, True)
    return M.narrow(acc[:ns], dtype), touched[:ns]


def lane_segment_fold(vals, valid, ids, num_segments: int,
                      monoid: str = "add"):
    """:func:`segment_fold` of ``B`` lanes at once: ``vals`` and ``valid``
    ``[B, N]``, ``ids`` ``[N]`` (shared) or ``[B, N]``; returns ``(acc,
    touched)`` ``[B, num_segments]``.  The reference's vmap rule: one fold
    over the flattened ``lane * num_segments + id`` segment space, with ids
    outside ``[0, num_segments)`` dropped within their lane."""
    ns = int(num_segments)
    lanes = vals.shape[0]
    ids = ids.to(torch.int64)
    keep = valid.to(torch.bool) & (ids >= 0) & (ids < ns)
    lane = torch.arange(lanes, device=vals.device)[:, None]
    flat = (lane * ns + ids).reshape(-1)
    acc, touched = segment_fold(vals.reshape(-1), keep.reshape(-1), flat,
                                lanes * ns, monoid)
    return acc.view(lanes, ns), touched.view(lanes, ns)


def segment_fold_cuda(vals, valid, ids, num_segments: int,
                      monoid: str = "add"):
    """Launch ``csrc/segment_fold.cu`` on the current stream (one launch:
    the kernel fills the outputs itself).  The engine calls this once per SC
    iteration, so it does no more on the host than check its inputs,
    allocate the outputs and make the one C call."""
    ns = int(num_segments)
    n, dev = vals.shape[0], vals.device
    _build.check_cuda(vals, "vals", shape=(n,))
    _build.check_cuda(valid, "valid", torch.bool, (n,), dev)
    _build.check_cuda(ids, "ids", torch.int32, (n,), dev)
    if ns <= 0:
        raise ValueError(f"num_segments must be positive, got {ns}")
    acc = torch.empty(ns, dtype=vals.dtype, device=dev)
    touched = torch.empty(ns, dtype=torch.bool, device=dev)
    _build.SEGMENT_FOLD.launch(
        vals.data_ptr(), valid.data_ptr(), ids.data_ptr(), n, ns,
        _build.MONOID_CODES[monoid], _build.dtype_code(vals.dtype, monoid),
        acc.data_ptr(), touched.data_ptr(), dev.index,
        _build.stream_handle(dev.index))
    return acc, touched


def blocked_segment_fold(vals, valid, ids, num_segments: int, *,
                         monoid: str = "add"):
    """Segmented monoid fold: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors.

    Args:
      vals:  [N] message value per slot (float32, int32 or uint32; int64
             with min: the packed words of ``min_with_payload``).
      valid: [N] bool validity; invalid slots contribute nothing.
      ids:   [N] int32 segment id per slot; ids outside
             ``[0, num_segments)`` contribute nothing.
      num_segments: segment count (the engine passes ``n_pad + 1``).
    Returns:
      acc [num_segments] monoid fold, touched [num_segments] bool.
    """
    if monoid not in _build.MONOID_CODES:
        raise ValueError(f"unknown monoid {monoid!r}")
    kind = vals.device.type
    if kind == "cpu":
        return segment_fold(vals, valid, ids, num_segments, monoid)
    if kind == "cuda":
        return segment_fold_cuda(vals, valid, ids, num_segments, monoid)
    raise ValueError(f"no segment fold for device {vals.device}")

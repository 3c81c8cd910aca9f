"""Fused scatter→fold DC step — the Gather phase without the message stream.

Counterpart of :func:`repro.kernels.fused_step.fused_scatter_fold`: for each
edge, gather ``table[idx]``; the edge counts iff ``table_valid[idx] &
edge_valid``; apply the optional edge function; fold add/min/max into
``acc[dst]`` and set ``touched[dst]``.  A ``dst`` outside
``[0, num_segments)`` is dropped.  Neither the ``[NM]`` message bins nor an
``[NE]`` edge-value stream is ever written.

Two versions, chosen by the device of the tensors:

  * :func:`ref_fused_scatter_fold`, the plain PyTorch version (CPU tensors;
    the oracle of the kernel on the card);
  * :func:`fused_dc_cuda`, the CUDA kernel ``csrc/fused_dc.cu`` (CUDA
    tensors): one thread block per destination partition, accumulating in
    shared memory.  It needs the partition structure of the gather-order
    edges, ``part_off`` (edge offset of each destination partition) and
    ``q``, and the precondition that every valid edge of partition ``p``
    has ``p*q <= dst < (p+1)*q`` (:class:`repro_torch.kernels.ops.FusedDCKernel`
    checks it once per layout).

The CUDA kernel knows one edge function, :func:`add_weight`; any other
``apply_weight`` raises on CUDA tensors.
"""
from __future__ import annotations

import os

import torch

from ..core import monoid as M
from . import _build
from .fold_block import segment_fold

ENV_FUSED = "REPRO_FUSED"

#: widest partition slice one thread block keeps in shared memory: 40960
#: four-byte accumulators plus touched bytes is 200 KB of the 227 KB limit
MAX_CHUNK = 40960


def fused_enabled() -> bool:
    """``REPRO_FUSED=0`` turns the fused DC step off: engines built while it
    is set run the composed scatter -> slot gather -> gather fold instead
    (the reference's own switch).  Default: on."""
    return os.environ.get(ENV_FUSED, "1") != "0"


def add_weight(vals, w):
    """SSSP's edge function (paper's applyWeight): ``val + wt``."""
    return vals + w


#: the edge functions the CUDA kernel knows, by their code in fused_dc.cu
_EDGE_FNS = {None: 0, add_weight: 1}


def ref_fused_scatter_fold(mono, table, table_valid, idx, edge_valid, dst,
                           num_segments: int, apply_weight=None, w=None):
    """Plain PyTorch version with :func:`fused_scatter_fold`'s contract."""
    idx = idx.to(torch.int64).clamp(0, table.shape[0] - 1)
    vals = M.from_bits(M.as_bits(table)[idx], table.dtype)
    valid = table_valid.to(torch.bool)[idx] & edge_valid.to(torch.bool)
    if apply_weight is not None:
        vals = apply_weight(vals, w).to(mono.dtype)
    return segment_fold(vals, valid, dst, num_segments, mono.name)


def fused_dc_cuda(table, table_valid, idx, edge_valid, dst,
                  num_segments: int, monoid: str, part_off, q: int,
                  apply_weight=None, w=None):
    """Launch ``csrc/fused_dc.cu`` on the current stream."""
    ns, ne, m = int(num_segments), idx.shape[0], table.shape[0]
    dev = table.device
    _build.check_cuda(table, "table", shape=(m,))
    _build.check_cuda(table_valid, "table_valid", torch.bool, (m,), dev)
    _build.check_cuda(idx, "idx", torch.int32, (ne,), dev)
    _build.check_cuda(edge_valid, "edge_valid", torch.bool, (ne,), dev)
    _build.check_cuda(dst, "dst", torch.int32, (ne,), dev)
    _build.check_cuda(part_off, "part_off", torch.int64, None, dev)
    k = part_off.shape[0] - 1
    if k < 1 or q < 1 or ns < k * q:
        raise ValueError(f"need k >= 1 partitions of q >= 1 segments within "
                         f"num_segments, got k={k} q={q} num_segments={ns}")
    if apply_weight not in _EDGE_FNS:
        raise ValueError("the CUDA fused DC kernel applies no edge function "
                         "but repro_torch.kernels.fused_step.add_weight")
    if apply_weight is not None:
        if table.dtype != torch.float32:
            raise TypeError("add_weight needs a float32 table")
        _build.check_cuda(w, "w", torch.float32, (ne,), dev)
    acc = torch.empty(ns, dtype=table.dtype, device=dev)
    touched = torch.empty(ns, dtype=torch.bool, device=dev)
    _build.FUSED_DC.launch(
        table.data_ptr(), table_valid.data_ptr(), m, idx.data_ptr(),
        edge_valid.data_ptr(), dst.data_ptr(),
        w.data_ptr() if apply_weight is not None else None,
        part_off.data_ptr(), k, int(q), min(int(q), MAX_CHUNK), ns,
        _build.MONOID_CODES[monoid], _build.dtype_code(table.dtype),
        _EDGE_FNS[apply_weight], acc.data_ptr(), touched.data_ptr(),
        _build.stream_handle())
    return acc, touched


def fused_scatter_fold(table, table_valid, idx, edge_valid, dst,
                       num_segments: int, *, monoid: str = "add",
                       part_off=None, q: int = None,
                       apply_weight=None, w=None):
    """Gather-from-table + edge function + segmented fold, fused.

    Contract (the reference's ``fused_dc``):

      table:       [M] source value per table slot (the engine passes the
                   vertex message array + identity sentinel).
      table_valid: [M] bool; a slot's messages contribute nothing when its
                   source is invalid (inactive / non-DC).
      idx:         [NE] int32 table slot per edge (clamped into range).
      edge_valid:  [NE] bool static structural validity per edge.
      dst:         [NE] int32 destination segment per edge.
      num_segments: segment count (the engine passes ``n_pad + 1``).
      part_off, q: the destination-partition structure (CUDA only).
      apply_weight, w: optional edge function ``f(vals, w)`` and [NE]
                   weights.
    Returns:
      acc [num_segments] monoid fold, touched [num_segments] bool.
    """
    if monoid not in _build.MONOID_CODES:
        raise ValueError(f"unknown monoid {monoid!r}")
    kind = table.device.type
    if kind == "cpu":
        mono = M.REGISTRY[monoid](table.dtype)
        return ref_fused_scatter_fold(mono, table, table_valid, idx,
                                      edge_valid, dst, num_segments,
                                      apply_weight=apply_weight, w=w)
    if kind == "cuda":
        if part_off is None or q is None:
            raise ValueError("the CUDA fused DC kernel needs part_off and q")
        return fused_dc_cuda(table, table_valid, idx, edge_valid, dst,
                             num_segments, monoid, part_off, q,
                             apply_weight=apply_weight, w=w)
    raise ValueError(f"no fused DC step for device {table.device}")

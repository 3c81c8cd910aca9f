"""Partition-centric SpMV: ``y[dst] += w * x[src]`` over the edge tiles.

Counterpart of :func:`repro.kernels.spmv_block.spmv_block` (f32 only): edge
tile ``t`` reads the source partition ``tile_src_part[t]`` of ``x`` and adds
into the destination partition ``tile_dst_part[t]`` of ``y``, which is reset
to 0 at each tile with ``tile_first`` set.  Invalid edges, edges whose
``edge_src_local`` or ``edge_dst_local`` lies outside ``[0, q)`` and tiles
whose source partition lies outside ``[0, k)`` add nothing; a partition that
no reset reaches is 0 (``SpmvKernel`` masks it in both packages).

Two versions, chosen by the device of the tensors:

  * :func:`ref_spmv_block`, the plain PyTorch version (CPU tensors; the
    oracle of the kernel on the card);
  * :func:`spmv_block_cuda`, the CUDA kernel ``csrc/spmv_block.cu`` (CUDA
    tensors), one thread block per destination partition with ``y`` in
    shared memory, reading ``part_tile_off`` as ``segment_combine_cuda``
    does.  The partition's edge tiles stream through a ring of
    shared-memory stages filled by asynchronous bulk copies
    (``csrc/edge_stream.cuh``) where ``edge_tile`` is a multiple of 16 and
    the edge arrays are 16-byte aligned, and are read with plain loads
    otherwise.

The reference sums by a one-hot matmul, where one non-finite product turns
its whole partition into NaN; both versions here add each product into its
own destination.  They agree on finite payloads.
"""
from __future__ import annotations

import torch

from . import _build
from .segment_combine import live_tiles

# The widest slice of a partition one thread block holds: y (4 B an output)
# beside the ring of edge stages in one block's shared memory
# (``kMaxChunk`` in csrc/spmv_block.cu).
MAX_CHUNK = 32768


def ref_spmv_block(x, edge_src_local, edge_dst_local, edge_valid, edge_w,
                   tile_dst_part, tile_src_part, tile_first, *, k: int,
                   q: int, edge_tile: int, weighted: bool = False):
    """Plain PyTorch version with :func:`spmv_block`'s contract."""
    src_part = tile_src_part.to(torch.int64)
    live = live_tiles(tile_dst_part, tile_first, k) & (src_part >= 0) \
        & (src_part < k)
    src_local = edge_src_local.to(torch.int64)
    dst_local = edge_dst_local.to(torch.int64)
    keep = edge_valid.to(torch.bool) & live.repeat_interleave(edge_tile) \
        & (src_local >= 0) & (src_local < q) & (dst_local >= 0) \
        & (dst_local < q)
    src = torch.where(keep, src_part.repeat_interleave(edge_tile) * q
                      + src_local, 0)
    vals = x.reshape(-1)[src]
    if weighted:
        vals = vals * edge_w
    seg = torch.where(
        keep, tile_dst_part.to(torch.int64).repeat_interleave(edge_tile) * q
        + dst_local, k * q)
    y = torch.zeros(k * q + 1, dtype=torch.float32, device=x.device)
    y.index_add_(0, seg, torch.where(keep, vals, 0.0))
    return y[:k * q].view(k, q)


def spmv_block_cuda(x, edge_src_local, edge_dst_local, edge_valid, edge_w,
                    tile_src_part, part_tile_off, *, k: int, q: int,
                    edge_tile: int, weighted: bool = False):
    """Launch ``csrc/spmv_block.cu`` on the current stream."""
    nt, dev = tile_src_part.shape[0], x.device
    ne = nt * edge_tile
    _build.check_cuda(x, "x", torch.float32, (k, q))
    _build.check_cuda(edge_src_local, "edge_src_local", torch.int32, (ne,),
                      dev)
    _build.check_cuda(edge_dst_local, "edge_dst_local", torch.int32, (ne,),
                      dev)
    _build.check_cuda(edge_valid, "edge_valid", torch.bool, (ne,), dev)
    if weighted:
        _build.check_cuda(edge_w, "edge_w", torch.float32, (ne,), dev)
    _build.check_cuda(tile_src_part, "tile_src_part", torch.int32, (nt,), dev)
    _build.check_cuda(part_tile_off, "part_tile_off", torch.int64, (k + 1,),
                      dev)
    if k < 1 or q < 1 or edge_tile < 1:
        raise ValueError(f"need k, q and edge_tile >= 1, got k={k} q={q} "
                         f"edge_tile={edge_tile}")
    y = torch.empty((k, q), dtype=torch.float32, device=dev)
    _build.SPMV_BLOCK.launch(
        x.data_ptr(), edge_src_local.data_ptr(), edge_dst_local.data_ptr(),
        edge_valid.data_ptr(), edge_w.data_ptr() if weighted else None,
        tile_src_part.data_ptr(), part_tile_off.data_ptr(), k, q, edge_tile,
        min(q, MAX_CHUNK), int(weighted), y.data_ptr(),
        _build.stream_handle(dev))
    return y


def spmv_block(x, edge_src_local, edge_dst_local, edge_valid, edge_w,
               tile_dst_part, tile_src_part, tile_first, *, k: int, q: int,
               edge_tile: int, weighted: bool = False, part_tile_off=None):
    """One partition-centric SpMV pass: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors.

    Args:
      x:              [k, q] float32 source values.
      edge_src_local, edge_dst_local: [NE] int32 ids within their partitions.
      edge_valid:     [NE] bool; edge_w [NE] float32, read when weighted.
      tile_dst_part, tile_src_part: [NT] int32 tile geometry.
      tile_first:     [NT] bool, the first tile of its destination partition.
      part_tile_off:  [k+1] int64 tile offset of each destination partition
                      (CUDA only).
    Returns:
      y [k, q] float32, ``A^T x`` with the weights when ``weighted``.
    """
    if x.dtype != torch.float32:
        raise TypeError(f"spmv_block is float32 only, got {x.dtype}")
    if weighted and edge_w is None:
        raise ValueError("a weighted SpMV needs edge_w")
    kind = x.device.type
    if kind == "cpu":
        return ref_spmv_block(x, edge_src_local, edge_dst_local, edge_valid,
                              edge_w, tile_dst_part, tile_src_part,
                              tile_first, k=k, q=q, edge_tile=edge_tile,
                              weighted=weighted)
    if kind == "cuda":
        if part_tile_off is None:
            raise ValueError("the CUDA spmv_block kernel needs part_tile_off")
        return spmv_block_cuda(x, edge_src_local, edge_dst_local, edge_valid,
                               edge_w, tile_src_part, part_tile_off, k=k, q=q,
                               edge_tile=edge_tile, weighted=weighted)
    raise ValueError(f"no SpMV for device {x.device}")

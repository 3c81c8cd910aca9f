"""The Gather phase of the composed DC path: fold edges per partition.

Counterpart of :func:`repro.kernels.segment_combine.segment_combine`: fold
the gather-order ``[NE]`` edge stream ``(edge_vals, edge_valid,
edge_dst_local)`` into ``acc[k, q]`` and ``touched[k, q]``.  Edge tile ``t``
(edges ``[t*edge_tile, (t+1)*edge_tile)``) folds into destination partition
``tile_dst_part[t]``; a partition's accumulator is reset to the identity at
each tile with ``tile_first`` set; a tile whose source partition
``tile_src_part[t]`` has ``part_active`` 0 is skipped whole (the paper's
2-level active list).  Invalid edges, edges whose ``edge_dst_local`` lies
outside ``[0, q)`` and tiles whose source partition lies outside ``[0, k)``
contribute nothing.  A partition that no reset reaches is the identity,
untouched (the TPU kernel leaves it unwritten; ``GatherKernel`` masks it in
both packages).

``[B, NE]`` edge values and validity with ``[B, k]`` ``part_active`` fold
``B`` lanes (the batched engine's queries) into ``[B, k, q]``, each lane
skipping the tiles of its own inactive source partitions.

Two versions, chosen by the device of the tensors:

  * :func:`ref_segment_combine`, the plain PyTorch version (CPU tensors; the
    oracle of the kernel on the card); lanes fold as the reference's vmap
    rule does, over a flattened ``lane * k * q + dst`` segment space;
  * :func:`segment_combine_cuda`, the CUDA kernel ``csrc/segment_combine.cu``
    (CUDA tensors): one thread block per destination partition, accumulating
    in shared memory.  It reads the tiles' destination structure as
    ``part_tile_off`` (tile offset of each destination partition, the
    ``tile_dst_part`` / ``tile_first`` of a destination-major layout), which
    :class:`repro_torch.kernels.ops.GatherKernel` derives and checks once
    per layout.  Lanes take its lane form (``segment_combine_lanes``): one
    launch, lane ``b`` on ``blockIdx.y``.

The reference folds float ``add`` by a one-hot matmul, so there a single
non-finite message turns its whole partition into NaN; both versions here
fold each edge into its own destination.  They agree on finite payloads.
"""
from __future__ import annotations

import torch

from . import _build
from .fold_block import lane_segment_fold, segment_fold
from .fused_step import max_chunk


def live_tiles(tile_dst_part, tile_first, k: int):
    """bool[NT]: tile ``t`` counts toward its destination partition ``p``:
    ``p`` lies in ``[0, k)``, has a reset tile, and no reset of ``p`` comes
    after ``t`` (the TPU kernel's sequential grid, as a mask)."""
    nt = tile_dst_part.shape[0]
    t = torch.arange(nt, device=tile_dst_part.device)
    dst = tile_dst_part.to(torch.int64)
    inside = (dst >= 0) & (dst < k)
    dst = torch.where(inside, dst, k)
    first = torch.where(tile_first.to(torch.bool) & inside, t, -1)
    last = torch.full((k + 1,), -1, dtype=torch.int64,
                      device=tile_dst_part.device)
    last.scatter_reduce_(0, dst, first, "amax")
    reset = last[dst]
    return inside & (reset >= 0) & (t >= reset)


def ref_segment_combine(edge_vals, edge_valid, edge_dst_local, tile_dst_part,
                        tile_src_part, tile_first, part_active, *, k: int,
                        q: int, edge_tile: int, monoid: str = "add"):
    """Plain PyTorch version with :func:`segment_combine`'s contract,
    lanes included."""
    src = tile_src_part.to(torch.int64)
    src_ok = (src >= 0) & (src < k)
    live = live_tiles(tile_dst_part, tile_first, k) & src_ok \
        & part_active.to(torch.bool)[..., torch.where(src_ok, src, 0)]
    dst_local = edge_dst_local.to(torch.int64)
    keep = edge_valid.to(torch.bool) \
        & live.repeat_interleave(edge_tile, dim=-1) \
        & (dst_local >= 0) & (dst_local < q)
    seg = tile_dst_part.to(torch.int64).repeat_interleave(edge_tile) * q \
        + dst_local
    fold = segment_fold if edge_vals.dim() == 1 else lane_segment_fold
    acc, touched = fold(edge_vals, keep, seg, k * q, monoid)
    shape = edge_vals.shape[:-1] + (k, q)
    return acc.view(shape), touched.view(shape)


def segment_combine_cuda(edge_vals, edge_valid, edge_dst_local, tile_src_part,
                         part_tile_off, part_active, *, k: int, q: int,
                         edge_tile: int, monoid: str = "add"):
    """Launch ``csrc/segment_combine.cu`` on the current stream:
    ``segment_combine`` for an ``[NE]`` stream, its lane form
    ``segment_combine_lanes`` for ``[B, NE]``."""
    nt, dev = tile_src_part.shape[0], edge_vals.device
    ne = nt * edge_tile
    lead = tuple(edge_vals.shape[:-1])
    if len(lead) > 1 or 0 in lead:
        raise ValueError(f"edge_vals must be [NE] or [B, NE] with B >= 1, got "
                         f"{tuple(edge_vals.shape)}")
    _build.check_cuda(edge_vals, "edge_vals", shape=lead + (ne,))
    _build.check_cuda(edge_valid, "edge_valid", torch.bool, lead + (ne,), dev)
    _build.check_cuda(edge_dst_local, "edge_dst_local", torch.int32, (ne,),
                      dev)
    _build.check_cuda(tile_src_part, "tile_src_part", torch.int32, (nt,), dev)
    _build.check_cuda(part_tile_off, "part_tile_off", torch.int64, (k + 1,),
                      dev)
    _build.check_cuda(part_active, "part_active", torch.bool, lead + (k,),
                      dev)
    if k < 1 or q < 1 or edge_tile < 1:
        raise ValueError(f"need k, q and edge_tile >= 1, got k={k} q={q} "
                         f"edge_tile={edge_tile}")
    acc = torch.empty(lead + (k, q), dtype=edge_vals.dtype, device=dev)
    touched = torch.empty(lead + (k, q), dtype=torch.bool, device=dev)
    args = (edge_vals.data_ptr(), edge_valid.data_ptr(),
            edge_dst_local.data_ptr(), tile_src_part.data_ptr(),
            part_tile_off.data_ptr(), part_active.data_ptr(), k, q, edge_tile,
            min(q, max_chunk(edge_vals.dtype)))
    codes = (_build.MONOID_CODES[monoid],
             _build.dtype_code(edge_vals.dtype, monoid))
    outs = (acc.data_ptr(), touched.data_ptr(), _build.stream_handle(dev))
    if not lead:
        _build.SEGMENT_COMBINE.launch(*args, *codes, *outs)
    else:
        _build.SEGMENT_COMBINE_LANES.launch(*args, lead[0], ne, k, k * q,
                                            *codes, *outs)
    return acc, touched


def segment_combine(edge_vals, edge_valid, edge_dst_local, tile_dst_part,
                    tile_src_part, tile_first, part_active, *, k: int, q: int,
                    edge_tile: int, monoid: str = "add", part_tile_off=None):
    """Fold edge messages into per-partition accumulators.

    Args:
      edge_vals:      [NE] message value per edge, gather order (float32,
                      int32 or uint32; int64 with min), or [B, NE]: B
                      lanes over the same tiles.
      edge_valid:     edge_vals' shape, bool validity (False on pads and
                      inactive-source slots).
      edge_dst_local: [NE] int32 destination id within its partition.
      tile_dst_part, tile_src_part: [NT] int32 tile geometry.
      tile_first:     [NT] bool, the first tile of its destination partition.
      part_active:    [k] (or [B, k]) bool source-partition activity
                      (gPartList).
      part_tile_off:  [k+1] int64 tile offset of each destination partition
                      (CUDA only; it stands for tile_dst_part and tile_first).
    Returns:
      acc [k, q] monoid fold, touched [k, q] bool (with a leading [B] for B
      lanes).
    """
    if monoid not in _build.MONOID_CODES:
        raise ValueError(f"unknown monoid {monoid!r}")
    kind = edge_vals.device.type
    if kind == "cpu":
        return ref_segment_combine(
            edge_vals, edge_valid, edge_dst_local, tile_dst_part,
            tile_src_part, tile_first, part_active, k=k, q=q,
            edge_tile=edge_tile, monoid=monoid)
    if kind == "cuda":
        if part_tile_off is None:
            raise ValueError("the CUDA segment_combine kernel needs "
                             "part_tile_off")
        return segment_combine_cuda(
            edge_vals, edge_valid, edge_dst_local, tile_src_part,
            part_tile_off, part_active, k=k, q=q, edge_tile=edge_tile,
            monoid=monoid)
    raise ValueError(f"no gather fold for device {edge_vals.device}")

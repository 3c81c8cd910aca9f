"""Fused scatter→fold DC step — the Gather phase without the message stream.

Counterpart of :func:`repro.kernels.fused_step.fused_scatter_fold`: for each
edge, gather ``table[idx]``; the edge counts iff ``table_valid[idx] &
edge_valid``; apply the optional edge function; fold add/min/max into
``acc[dst]`` and set ``touched[dst]``.  A ``dst`` outside
``[0, num_segments)`` is dropped.  Neither the ``[NM]`` message bins nor an
``[NE]`` edge-value stream is ever written.

A ``[B, M]`` table and validity fold ``B`` lanes (the batched engine's
queries) into ``[B, num_segments]``: the reference's vmapped step.

Two versions, chosen by the device of the tensors:

  * :func:`ref_fused_scatter_fold`, the plain PyTorch version (CPU tensors;
    the oracle of the kernel on the card), on the global ``idx`` and
    ``dst`` of the reference's contract; lanes fold as the reference's
    vmap rule does, over a flattened ``lane * num_segments + dst`` segment
    space (:func:`repro_torch.kernels.fold_block.lane_segment_fold`);
  * :func:`fused_dc_cuda`, the CUDA kernel ``csrc/fused_dc.cu`` (CUDA
    tensors): one thread block per destination partition, accumulating in
    shared memory.  It reads the edges in the layout's tile form,
    :class:`EdgeTiles`, in place of ``idx`` and ``dst``: edge ``e`` of tile
    ``t`` has ``idx = clamp(tile_src_part[t] * q + edge_src_local[e])`` and
    ``dst = p * q + edge_dst_local[e]``, ``p`` the destination partition
    whose tile range (``part_tile_off``) holds ``t``.
    :class:`repro_torch.kernels.ops.FusedDCKernel` checks once per layout
    that this is the layout's ``edge_dst`` on every valid edge, and
    :func:`global_edges` builds ``idx`` and ``dst`` from the tiles for the
    plain version.  Lanes take the kernel's lane form (``fused_dc_lanes``):
    one launch, lane ``b`` on ``blockIdx.y``;
  * :func:`fused_stream_cuda`, the CUDA kernel ``csrc/fused_stream.cu``
    (CUDA tensors with ``idx`` and ``dst``, no ``tiles``): the layout-free
    form, which the distributed engine calls on its receive table
    (:class:`repro_torch.kernels.ops.FusedStreamKernel`).  The stream fold
    of ``csrc/segment_fold.cu`` with the table gather and the edge function
    in its message load: any ``dst``, one cooperative launch, in shared
    memory up to 40,960 segments (22,752 for ``int64``), global atomics
    past that.  One table a call.

The CUDA kernel knows two edge functions, :func:`add_weight` (float32
tables) and :func:`add_weight_to_key` (the ``int64`` packed words of
``min_with_payload``); any other ``apply_weight`` raises on CUDA tensors.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core import monoid as M
from . import _build
from .fold_block import lane_segment_fold, segment_fold

ENV_FUSED = "REPRO_FUSED"

#: widest partition slice one thread block keeps in shared memory: 32768
#: four-byte accumulators and touched bytes (160 KB) beside the ring of edge
#: stages, under the 227 KB limit (``kMaxChunk<T>`` in csrc/fused_dc.cu and
#: csrc/segment_combine.cu); 16384 eight-byte ones (144 KB)
MAX_CHUNK = 32768
WIDE_MAX_CHUNK = 16384


def max_chunk(dtype: torch.dtype) -> int:
    """The widest partition slice a block of the tile kernels holds for
    accumulators of ``dtype``."""
    return WIDE_MAX_CHUNK if dtype.itemsize == 8 else MAX_CHUNK


def fused_enabled() -> bool:
    """``REPRO_FUSED=0`` turns the fused DC step off: engines built while it
    is set run the composed scatter -> slot gather -> gather fold instead
    (the reference's own switch).  Default: on."""
    return os.environ.get(ENV_FUSED, "1") != "0"


def add_weight(vals, w):
    """SSSP's edge function (paper's applyWeight): ``val + wt``."""
    return vals + w


def add_weight_to_key(vals, w):
    """SSSP-with-parents' edge function on packed ``min_with_payload``
    words: ``w`` added to the f32 key (one f32 add, as the reference's
    ``pack(key + w, payload)``), the payload kept."""
    key, payload = M.unpack_key_payload(vals)
    return M.pack_key_payload(key + w, payload)


#: the edge functions the CUDA kernel knows, by their code in fused_dc.cu,
#: and the table type each takes
_EDGE_FNS = {None: 0, add_weight: 1, add_weight_to_key: 2}
_EDGE_DTYPES = {add_weight: torch.float32, add_weight_to_key: torch.int64}


class EdgeTiles(NamedTuple):
    """The gather-order edges in a destination-major layout's tile form, on
    one device: what the CUDA kernel reads in place of ``idx`` and ``dst``.

    ``part_tile_off`` ([k+1] int64) gives each destination partition's tiles;
    ``tile_src_part`` ([NT] int32) each tile's source partition;
    ``edge_src_local``, ``edge_dst_local`` ([NT * edge_tile] int32) each
    edge's ids within its partitions."""
    edge_src_local: torch.Tensor
    edge_dst_local: torch.Tensor
    tile_src_part: torch.Tensor
    part_tile_off: torch.Tensor
    q: int
    edge_tile: int


def global_edges(tile_src_part, tile_dst_part, edge_src_local, edge_dst_local,
                 edge_valid, *, q: int, edge_tile: int, n_pad: int):
    """``(idx, dst)``, int32 ``[NE]``, of the tile form, with torch ops on the
    tensors' device: ``idx`` the global source clamped into ``[0, n_pad]``,
    ``dst`` the global destination on valid edges and the sentinel ``n_pad``
    on the others (the reference layout's ``edge_dst``)."""
    src_part = tile_src_part.to(torch.int64).repeat_interleave(edge_tile)
    idx = (src_part * q + edge_src_local).clamp_(0, n_pad).to(torch.int32)
    del src_part
    dst_part = tile_dst_part.to(torch.int64).repeat_interleave(edge_tile)
    dst = torch.where(edge_valid.to(torch.bool), dst_part * q + edge_dst_local,
                      n_pad).to(torch.int32)
    return idx, dst


def ref_fused_scatter_fold(mono, table, table_valid, idx, edge_valid, dst,
                           num_segments: int, apply_weight=None, w=None):
    """Plain PyTorch version with :func:`fused_scatter_fold`'s contract,
    lanes included."""
    idx = idx.to(torch.int64).clamp(0, table.shape[-1] - 1)
    vals = M.from_bits(M.as_bits(table).index_select(-1, idx), table.dtype)
    valid = (table_valid.to(torch.bool).index_select(-1, idx)
             & edge_valid.to(torch.bool))
    if apply_weight is not None:
        vals = apply_weight(vals, w).to(mono.dtype)
    fold = segment_fold if table.dim() == 1 else lane_segment_fold
    return fold(vals, valid, dst, num_segments, mono.name)


def _kernel_codes(table, monoid: str, apply_weight, w, ne: int) -> tuple:
    """``(monoid, dtype, edge_fn)`` codes of both CUDA forms; raises for an
    edge function they do not know, a table type it does not take, or
    weights that are not ``[ne]`` f32 on the table's device."""
    if apply_weight not in _EDGE_FNS:
        raise ValueError("the CUDA fused DC kernel applies no edge function "
                         "but repro_torch.kernels.fused_step.add_weight and "
                         "add_weight_to_key")
    codes = (_build.MONOID_CODES[monoid],
             _build.dtype_code(table.dtype, monoid), _EDGE_FNS[apply_weight])
    if apply_weight is not None:
        want = _EDGE_DTYPES[apply_weight]
        if table.dtype != want:
            raise TypeError(f"{apply_weight.__name__} needs a {want} table")
        _build.check_cuda(w, "w", torch.float32, (ne,), table.device)
    return codes


def fused_dc_cuda(table, table_valid, edge_valid, num_segments: int,
                  monoid: str, tiles: EdgeTiles, apply_weight=None, w=None):
    """Launch ``csrc/fused_dc.cu`` on the current stream: ``fused_dc`` for
    a ``[M]`` table, its lane form ``fused_dc_lanes`` for ``[B, M]``."""
    ns, shape = int(num_segments), tuple(table.shape)
    dev = table.device
    if len(shape) not in (1, 2) or 0 in shape:
        raise ValueError(f"table must be [M] or [B, M] with B, M >= 1, got "
                         f"{shape}")
    m, lanes = shape[-1], shape[0] if len(shape) == 2 else None
    nt, q, et = tiles.tile_src_part.shape[0], int(tiles.q), int(tiles.edge_tile)
    k, ne = tiles.part_tile_off.shape[0] - 1, nt * et
    _build.check_cuda(table, "table")
    _build.check_cuda(table_valid, "table_valid", torch.bool, shape, dev)
    _build.check_cuda(edge_valid, "edge_valid", torch.bool, (ne,), dev)
    _build.check_cuda(tiles.edge_src_local, "edge_src_local", torch.int32,
                      (ne,), dev)
    _build.check_cuda(tiles.edge_dst_local, "edge_dst_local", torch.int32,
                      (ne,), dev)
    _build.check_cuda(tiles.tile_src_part, "tile_src_part", torch.int32,
                      (nt,), dev)
    _build.check_cuda(tiles.part_tile_off, "part_tile_off", torch.int64,
                      (k + 1,), dev)
    if k < 1 or q < 1 or et < 1 or ns < k * q:
        raise ValueError(f"need k, q and edge_tile >= 1 and k*q segments "
                         f"within num_segments, got k={k} q={q} "
                         f"edge_tile={et} num_segments={ns}")
    codes = _kernel_codes(table, monoid, apply_weight, w, ne)
    acc = torch.empty(shape[:-1] + (ns,), dtype=table.dtype, device=dev)
    touched = torch.empty(shape[:-1] + (ns,), dtype=torch.bool, device=dev)
    edges = (tiles.edge_src_local.data_ptr(), tiles.edge_dst_local.data_ptr(),
             edge_valid.data_ptr(),
             w.data_ptr() if apply_weight is not None else None,
             tiles.tile_src_part.data_ptr(), tiles.part_tile_off.data_ptr(),
             k, q, et, min(q, max_chunk(table.dtype)), ns)
    outs = (acc.data_ptr(), touched.data_ptr(), _build.stream_handle(dev))
    if lanes is None:
        _build.FUSED_DC.launch(table.data_ptr(), table_valid.data_ptr(), m,
                               *edges, *codes, *outs)
    else:
        _build.FUSED_DC_LANES.launch(
            table.data_ptr(), table_valid.data_ptr(), m, m, *edges, lanes,
            ns, *codes, *outs)
    return acc, touched


def fused_stream_cuda(table, table_valid, idx, edge_valid, dst,
                      num_segments: int, monoid: str, apply_weight=None,
                      w=None):
    """Launch ``csrc/fused_stream.cu`` on the current stream: the
    layout-free fused step over ``idx`` and ``dst``, for one ``[M]``
    table."""
    ns, dev = int(num_segments), table.device
    if table.dim() != 1 or table.shape[0] < 1:
        raise ValueError(f"the layout-free fused DC kernel takes one [M] "
                         f"table with M >= 1, got {tuple(table.shape)}")
    m, ne = table.shape[0], idx.shape[0]
    _build.check_cuda(table, "table")
    _build.check_cuda(table_valid, "table_valid", torch.bool, (m,), dev)
    _build.check_cuda(idx, "idx", torch.int32, (ne,), dev)
    _build.check_cuda(edge_valid, "edge_valid", torch.bool, (ne,), dev)
    _build.check_cuda(dst, "dst", torch.int32, (ne,), dev)
    if ns <= 0:
        raise ValueError(f"num_segments must be positive, got {ns}")
    codes = _kernel_codes(table, monoid, apply_weight, w, ne)
    acc = torch.empty(ns, dtype=table.dtype, device=dev)
    touched = torch.empty(ns, dtype=torch.bool, device=dev)
    _build.FUSED_STREAM.launch(
        table.data_ptr(), table_valid.data_ptr(), m, idx.data_ptr(),
        edge_valid.data_ptr(), dst.data_ptr(),
        w.data_ptr() if apply_weight is not None else None, ne, ns, *codes,
        acc.data_ptr(), touched.data_ptr(), dev.index,
        _build.stream_handle(dev.index))
    return acc, touched


def fused_scatter_fold(table, table_valid, idx, edge_valid, dst,
                       num_segments: int, *, monoid: str = "add",
                       tiles: EdgeTiles = None, apply_weight=None, w=None):
    """Gather-from-table + edge function + segmented fold, fused.

    Contract (the reference's ``fused_dc``):

      table:       [M] source value per table slot (the engine passes the
                   vertex message array + identity sentinel), or [B, M]: B
                   lanes over the same edges.
      table_valid: table's shape, bool; a slot's messages contribute
                   nothing when its source is invalid (inactive / non-DC).
      idx:         [NE] int32 table slot per edge (clamped into range).
      edge_valid:  [NE] bool static structural validity per edge.
      dst:         [NE] int32 destination segment per edge.
      num_segments: segment count (the engine passes ``n_pad + 1``).
      tiles:       CUDA only, in place of ``idx`` and ``dst`` (which must
                   then be None): the edges' tile form, :class:`EdgeTiles`.
                   Without it a CUDA call takes ``idx`` and ``dst`` and
                   launches the layout-free kernel (one ``[M]`` table).
      apply_weight, w: optional edge function ``f(vals, w)`` and [NE]
                   weights.
    Returns:
      acc [num_segments] monoid fold, touched [num_segments] bool (with a
      leading [B] for B lanes).
    """
    if monoid not in _build.MONOID_CODES:
        raise ValueError(f"unknown monoid {monoid!r}")
    kind = table.device.type
    if kind == "cpu":
        mono = M.make(monoid, table.dtype)
        return ref_fused_scatter_fold(mono, table, table_valid, idx,
                                      edge_valid, dst, num_segments,
                                      apply_weight=apply_weight, w=w)
    if kind == "cuda":
        if (tiles is None) == (idx is None or dst is None):
            raise ValueError("the CUDA fused DC kernel reads the edges either "
                             "in their tile form (tiles=EdgeTiles(...), "
                             "idx=dst=None) or as idx and dst (tiles=None)")
        if tiles is None:
            return fused_stream_cuda(table, table_valid, idx, edge_valid, dst,
                                     num_segments, monoid,
                                     apply_weight=apply_weight, w=w)
        return fused_dc_cuda(table, table_valid, edge_valid, num_segments,
                             monoid, tiles, apply_weight=apply_weight, w=w)
    raise ValueError(f"no fused DC step for device {table.device}")

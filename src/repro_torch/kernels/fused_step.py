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
    plain version.  Lanes take the kernel's lane form: ``fused_dc_interleave``
    writes the ``[B, M]`` tables as ``[M, B]`` (rows ranked by use) and
    their validity as a bit mask a row (:func:`ref_interleave_lanes` is its
    plain version), then
    ``fused_dc_lanes`` folds :func:`lane_group` lanes of a sub-slice of
    :func:`lane_width` destinations a block over :class:`LaneEdges`, a
    destination-sorted copy of the edges (:func:`build_lane_edges`; the
    engines share one a layout and device), which each group of lanes reads
    once;
  * :func:`fused_stream_cuda`, the CUDA kernel ``csrc/fused_stream.cu``
    (CUDA tensors with ``idx`` and ``dst``, no ``tiles``): the layout-free
    form, which the distributed engine calls on its receive table
    (:class:`repro_torch.kernels.ops.FusedStreamKernel`).  One table a
    call, in one of two regimes.  With ``parts``, a :class:`PartRanges`
    (the engine's, from :func:`part_ranges`), each destination partition's
    edges are one range of the stream, and one thread block folds a chunk
    of a partition in shared memory, as the tile form does.  Without it,
    any ``dst``: the stream fold of ``csrc/segment_fold.cu`` with the table
    gather and the edge function in its message load, one cooperative
    launch, in shared memory up to 40,960 segments (22,752 for ``int64``),
    global atomics past that.

The CUDA kernel knows two edge functions, :func:`add_weight` (float32
tables) and :func:`add_weight_to_key` (the ``int64`` packed words of
``min_with_payload``); any other ``apply_weight`` raises on CUDA tensors.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

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

#: the lane form: destinations between two offsets of the edge copy, the
#: most lanes a block folds, and the shared memory a block's accumulators
#: and touched flags may take so that two blocks fit an SM (233,472 B, less
#: 1 KB reserved a block)
LANE_FINE = 128
LANE_MAX_GROUP = 16
LANE_SMEM = 113_664


#: the longest tile of the layout-free kernel's partitioned regime: one
#: stage of its weighted ring (``RingFor<true>`` in csrc/fused_edges.cuh);
#: a warp of its plain-load kernel takes one tile at a time
PARTS_MAX_TILE = 1536


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


class PartRanges(NamedTuple):
    """A stream's destination-partition edge ranges, on the edges' device:
    what the layout-free kernel's partitioned regime reads beside ``idx``
    and ``dst``.

    Partition ``j``'s edges are ``[part_off[j], part_off[j+1])``
    (``part_off``: int64 ``[parts + 1]``, nondecreasing multiples of
    ``tile`` that divides the stream's length), and an edge there folds
    only into a ``dst`` in ``[j * q, (j + 1) * q)``.  This is the
    reference's function wherever every edge with ``edge_valid`` and a
    ``dst`` in ``[0, num_segments)`` lies in the range of partition ``dst //
    q < parts``: :func:`part_ranges` checks that when it derives them."""
    part_off: torch.Tensor
    q: int
    tile: int


def _gcd(x) -> int:
    """The gcd of a 1-D int64 tensor's entries (0 for none), reduced in
    halves on its device."""
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x[:1]])
        x = torch.gcd(x[0::2], x[1::2])
    return int(x[0]) if x.numel() else 0


def part_ranges(dst, edge_valid, q: int, parts: int) -> PartRanges:
    """The :class:`PartRanges` of a stream whose valid edges come grouped
    by destination partition ``dst // q`` in increasing order (a rank's
    received edges in the layout's gather order), with torch ops on the
    tensors' device; raises ``ValueError`` unless every valid edge lies in
    the range of its partition, one of ``[0, parts)``.

    Partition ``j`` starts at its first valid edge (at the next
    partition's start where it has none).  The tile is the largest divisor
    of at most ``PARTS_MAX_TILE`` of the gcd of the starts, of the valid
    runs' starts (a valid edge after an invalid one: the layout pads each block
    to its edge tile, and the next block starts there) and of the stream's
    length; the last range ends at the first multiple of the tile past the
    last valid edge.  On a layout's slice these are its ``blk_off``
    boundaries where the gcd is the layout's edge tile."""
    ne, dev = dst.shape[0], dst.device
    valid = edge_valid.to(torch.bool)
    e = valid.nonzero().squeeze(1)
    part = dst[e].to(torch.int64).div(q, rounding_mode="floor")
    first = torch.searchsorted(part, torch.arange(parts, device=dev))
    runs = (valid[1:] & ~valid[:-1]).nonzero().squeeze(1) + 1
    g = _gcd(torch.cat([e[first[first < e.numel()]], runs,
                        torch.tensor([ne], device=dev)])) or PARTS_MAX_TILE
    tile = next(t for t in range(min(g, PARTS_MAX_TILE), 0, -1)
                if g % t == 0)
    end = -(-(int(e[-1]) + 1) // tile) * tile if e.numel() else 0
    part_off = torch.cat([e, torch.tensor([end], device=dev)])[first]
    part_off = torch.cat([part_off, torch.tensor([end], device=dev)])
    held = torch.searchsorted(part_off[1:], e, right=True)
    stray = ((held != part) | (part < 0) | (part >= parts)).nonzero()
    if stray.numel():
        i = int(e[stray[0, 0]])
        raise ValueError(
            f"edge {i} (dst {int(dst[i])}, partition "
            f"{int(dst[i]) // q}) lies outside its destination partition's "
            f"range of the stream: the layout-free kernel's partitioned "
            f"regime needs each partition's valid edges together, in "
            f"partition order")
    return PartRanges(part_off, q, tile)


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


class LaneEdges(NamedTuple):
    """The lane form's copy of a tile form's edges (:func:`build_lane_edges`):
    the valid edges of each destination partition sorted by destination, a
    destination's edges in gather order.

    ``rank`` (int32 ``[k*q + 1]``) orders the table's entries by the number
    of the copy's edges they source, most first (ties by index): the
    interleaved table holds entry ``v`` at row ``rank[v]``.  ``src`` (int32)
    each edge's source row, ``rank[clamp(tile_src_part * q +
    edge_src_local, 0, k*q)]``; ``dst`` (int32) its destination within its
    partition; ``w`` (f32) its weight or None; ``off`` (int64 ``[k *
    ceil(q / fine) + 1]``) the offsets of each ``fine`` destinations of a
    partition.  ``edge_valid`` and ``w_from`` are the arrays it was built
    from: a lane launch takes it only with those, and with a table of
    ``k*q + 1`` entries."""
    src: torch.Tensor
    dst: torch.Tensor
    w: Optional[torch.Tensor]
    off: torch.Tensor
    rank: torch.Tensor
    fine: int
    edge_valid: torch.Tensor
    w_from: Optional[torch.Tensor]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.src, self.dst, self.w, self.off, self.rank)
                   if t is not None)


def _lane_order(tiles: EdgeTiles, edge_valid):
    """``(e, part, dst)``, int64: the gather-order indices of the edges with
    ``edge_valid`` and a destination in ``[0, q)`` (the others fold
    nothing), stably sorted by (destination partition, destination), and
    their destination partitions and local destinations."""
    q, et = int(tiles.q), int(tiles.edge_tile)
    k = tiles.part_tile_off.shape[0] - 1
    tile_dst = torch.repeat_interleave(
        torch.arange(k, device=edge_valid.device), tiles.part_tile_off.diff())
    local = tiles.edge_dst_local
    keep = edge_valid.to(torch.bool) & (local >= 0) & (local < q)
    e = keep.nonzero().squeeze(1)
    del keep
    part = tile_dst[e // et]
    dst = local[e].to(torch.int64)
    order = torch.sort(part * q + dst, stable=True).indices
    return e[order], part[order], dst[order]


def build_lane_edges(tiles: EdgeTiles, edge_valid, w=None,
                     fine: int = LANE_FINE) -> LaneEdges:
    """:class:`LaneEdges` of ``tiles`` on their device: the edges of
    :func:`_lane_order`, with ``w`` (gather order, or None) in the same
    order, and the table's rows ranked by how many of them each entry
    sources."""
    q, et = int(tiles.q), int(tiles.edge_tile)
    k = tiles.part_tile_off.shape[0] - 1
    dev = edge_valid.device
    n_fine = -(-q // fine)
    e, part, dst = _lane_order(tiles, edge_valid)
    src = (tiles.tile_src_part[e // et].to(torch.int64) * q
           + tiles.edge_src_local[e]).clamp_(0, k * q)
    counts = torch.bincount(part * n_fine + dst // fine,
                            minlength=k * n_fine)
    off = torch.zeros(k * n_fine + 1, dtype=torch.int64, device=dev)
    off[1:] = counts.cumsum(0)
    by_use = torch.sort(-torch.bincount(src, minlength=k * q + 1),
                        stable=True).indices
    rank = torch.empty(k * q + 1, dtype=torch.int64, device=dev)
    rank[by_use] = torch.arange(k * q + 1, device=dev)
    return LaneEdges(rank[src].to(torch.int32), dst.to(torch.int32),
                     w[e].contiguous() if w is not None else None, off,
                     rank.to(torch.int32), fine, edge_valid, w)


def with_lane_weights(le: LaneEdges, tiles: EdgeTiles, w) -> LaneEdges:
    """``le`` (built from ``tiles``) with the weights ``w`` (gather order)
    in its edges' order; its other arrays are ``le``'s own, not copies."""
    e = _lane_order(tiles, le.edge_valid)[0]
    return le._replace(w=w[e].contiguous(), w_from=w)


def lane_group(lanes: int) -> int:
    """Lanes one block of the lane form folds: the largest power of two
    that divides ``lanes``, at most ``LANE_MAX_GROUP``."""
    return min(lanes & -lanes, LANE_MAX_GROUP)


def lane_width(group: int, itemsize: int, q: int,
               fine: int = LANE_FINE) -> int:
    """Destinations a block of the lane form holds for ``group`` lanes of
    ``itemsize``-byte accumulators: the most multiples of ``fine`` whose
    rows (``width + 1`` accumulators and ``width + 4`` touched bytes a lane)
    fit ``LANE_SMEM``, at most q rounded up to ``fine``."""
    most = (LANE_SMEM // group - itemsize - 4) // (itemsize + 1)
    return max(fine, min(most // fine, -(-q // fine)) * fine)


def ref_interleave_lanes(table, table_valid, rank=None):
    """Plain version of ``fused_dc_interleave``: ``[B, M]`` tables and
    validity to the ``[M, B]`` table and the ``[M, ceil(B / 32)]`` int32
    masks whose bit ``b % 32`` of word ``b // 32`` is lane ``b``'s
    validity; entry ``v`` at row ``rank[v]`` (``[M]``; None: row ``v``)."""
    lanes, m = table.shape
    dev = table.device
    rows = (torch.arange(m, device=dev) if rank is None
            else rank.to(torch.int64))
    bits = M.as_bits(table)
    il = torch.empty((m, lanes), dtype=bits.dtype, device=dev)
    il[rows] = bits.t()
    words = -(-lanes // 32)
    flags = torch.zeros((m, words * 32), dtype=torch.int64, device=dev)
    flags[:, :lanes] = table_valid.t().to(torch.int64)
    mask = (flags.view(m, words, 32)
            << torch.arange(32, device=dev)).sum(-1)
    out = torch.empty((m, words), dtype=torch.int32, device=dev)
    out[rows] = (mask - ((mask >> 31) << 32)).to(torch.int32)
    return M.from_bits(il, table.dtype), out


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
                  monoid: str, tiles: EdgeTiles, apply_weight=None, w=None,
                  lane_edges: Optional[LaneEdges] = None):
    """Launch ``csrc/fused_dc.cu`` on the current stream: ``fused_dc`` for
    a ``[M]`` table; for ``[B, M]``, ``fused_dc_interleave`` then
    ``fused_dc_lanes`` over ``lane_edges``, which must have been built
    (:func:`build_lane_edges`) from ``tiles``, this ``edge_valid`` and,
    with an edge function, this ``w``."""
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
    outs = (acc.data_ptr(), touched.data_ptr(), _build.stream_handle(dev))
    if lanes is None:
        _build.FUSED_DC.launch(
            table.data_ptr(), table_valid.data_ptr(), m,
            tiles.edge_src_local.data_ptr(), tiles.edge_dst_local.data_ptr(),
            edge_valid.data_ptr(),
            w.data_ptr() if apply_weight is not None else None,
            tiles.tile_src_part.data_ptr(), tiles.part_tile_off.data_ptr(),
            k, q, et, min(q, max_chunk(table.dtype)), ns, *codes, *outs)
        return acc, touched
    wt = w if apply_weight is not None else None
    le = lane_edges
    if le is None:
        raise ValueError("the lane form reads the edges' lane copy: pass "
                         "lane_edges=build_lane_edges(tiles, edge_valid, w)")
    if le.edge_valid is not edge_valid or (wt is not None
                                           and le.w_from is not wt):
        raise ValueError("lane_edges were built from another edge_valid or "
                         "w than this call's")
    n_fine = -(-q // le.fine)
    if m != k * q + 1:
        raise ValueError(f"the lane form takes a table of k*q + 1 = "
                         f"{k * q + 1} entries (its edge copy's rows), got "
                         f"{m}")
    _build.check_cuda(le.off, "lane_edges.off", torch.int64,
                      (k * n_fine + 1,), dev)
    _build.check_cuda(le.rank, "lane_edges.rank", torch.int32, (m,), dev)
    _build.check_cuda(le.src, "lane_edges.src", torch.int32, device=dev)
    _build.check_cuda(le.dst, "lane_edges.dst", torch.int32, le.src.shape,
                      dev)
    if wt is not None:
        _build.check_cuda(le.w, "lane_edges.w", torch.float32, le.src.shape,
                          dev)
    size = table.element_size()
    group = lane_group(lanes)
    table_il = torch.empty((m, lanes), dtype=table.dtype, device=dev)
    mask = torch.empty((m, -(-lanes // 32)), dtype=torch.int32, device=dev)
    stream = _build.stream_handle(dev)
    _build.FUSED_DC_INTERLEAVE.launch(
        table.data_ptr(), table_valid.data_ptr(), m, m, lanes, size,
        le.rank.data_ptr(), table_il.data_ptr(), mask.data_ptr(), stream)
    _build.FUSED_DC_LANES.launch(
        table_il.data_ptr(), mask.data_ptr(), m, lanes, le.src.data_ptr(),
        le.dst.data_ptr(), le.w.data_ptr() if wt is not None else None,
        le.off.data_ptr(), k, q, le.fine,
        lane_width(group, size, q, le.fine), group, ns, ns, *codes, *outs)
    return acc, touched


def fused_stream_cuda(table, table_valid, idx, edge_valid, dst,
                      num_segments: int, monoid: str, apply_weight=None,
                      w=None, parts: Optional[PartRanges] = None):
    """Launch ``csrc/fused_stream.cu`` on the current stream: the
    layout-free fused step over ``idx`` and ``dst``, for one ``[M]`` table;
    in the partitioned regime over ``parts``' ranges, else in the stream
    regime."""
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
    ranges = (None, 0, 0, 0)
    if parts is not None:
        off, q, tile = parts
        _build.check_cuda(off, "parts.part_off", torch.int64, device=dev)
        n_parts = off.shape[0] - 1 if off.dim() == 1 else 0
        if n_parts < 1 or q < 1 or tile < 1 or ne % tile or n_parts * q > ns:
            raise ValueError(
                f"parts needs part_off [P + 1] with P >= 1, q >= 1, P * q <= "
                f"num_segments and a tile dividing the {ne} edges; got "
                f"part_off {tuple(off.shape)}, q={q}, tile={tile}, "
                f"num_segments={ns}")
        ranges = (off.data_ptr(), n_parts, q, tile)
    codes = _kernel_codes(table, monoid, apply_weight, w, ne)
    acc = torch.empty(ns, dtype=table.dtype, device=dev)
    touched = torch.empty(ns, dtype=torch.bool, device=dev)
    _build.FUSED_STREAM.launch(
        table.data_ptr(), table_valid.data_ptr(), m, idx.data_ptr(),
        edge_valid.data_ptr(), dst.data_ptr(),
        w.data_ptr() if apply_weight is not None else None, ne, *ranges, ns,
        *codes, acc.data_ptr(), touched.data_ptr(), dev.index,
        _build.stream_handle(dev.index))
    _build.FUSED_STREAM.count_regime(int(parts is not None))
    return acc, touched


def fused_scatter_fold(table, table_valid, idx, edge_valid, dst,
                       num_segments: int, *, monoid: str = "add",
                       tiles: EdgeTiles = None, apply_weight=None, w=None,
                       lane_edges: Optional[LaneEdges] = None,
                       parts: Optional[PartRanges] = None):
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
      lane_edges:  CUDA lanes only, and needed there: the lane form's edge
                   copy of ``tiles`` (:func:`build_lane_edges`).
      parts:       CUDA with ``idx`` and ``dst`` only: the stream's
                   destination-partition ranges (:class:`PartRanges`),
                   which select the layout-free kernel's partitioned
                   regime.  The plain version ignores them: where they
                   hold (:func:`part_ranges` checks it), they do not change
                   the function.
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
                                     apply_weight=apply_weight, w=w,
                                     parts=parts)
        if parts is not None:
            raise ValueError("parts are the layout-free kernel's: the tile "
                             "form has its partitions in tiles")
        return fused_dc_cuda(table, table_valid, edge_valid, num_segments,
                             monoid, tiles, apply_weight=apply_weight, w=w,
                             lane_edges=lane_edges)
    raise ValueError(f"no fused DC step for device {table.device}")

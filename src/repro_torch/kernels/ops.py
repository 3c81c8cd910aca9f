"""Engine-facing wrappers around the port's kernels.

Counterparts of ``FoldKernel``, ``FusedDCKernel``, ``FusedStreamKernel``,
``ScatterKernel``, ``GatherKernel`` and ``SpmvKernel`` in
:mod:`repro.kernels.ops` (the reference's pure-jnp ``Ref*`` classes are
``plain=True`` here).  The layout-bound classes bind a layout once: they
move its arrays to the engine's device and check the preconditions of the
CUDA kernels, per tile on the host and, for the fused kernel, per edge on
the device.

``FusedDCKernel``, ``GatherKernel`` and ``ScatterKernel`` also take inputs
with a leading lane axis ``[B, ...]``, the batched engine's queries, and then
return ``[B, ...]``: on a card, one launch of the kernel's lane form.

Each takes ``plain=True`` to run the plain PyTorch versions on any device;
``chip_smoke.py`` uses that to hold a whole app run on the card against the
kernels.  Otherwise the device of the tensors decides: the plain version on
the CPU, the CUDA kernel on a card.  The launch counts live with the kernels
(:data:`repro_torch.kernels._build.KERNELS`).

Each call runs under :func:`repro_torch.obs.tracing.kernel_scope`, named
``ppm.<kernel>.<cuda|plain>`` after the route it takes (the reference's
``ppm.<kernel>.<backend>``), so an ``obs.trace`` capture attributes the
card's kernels to their wrapper; the lane and int64 forms keep their
kernel's name.
"""
from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from ..core import monoid as M
from ..obs.tracing import kernel_scope
from .dc_gather import dc_gather, dc_pieces, ref_dc_gather
from .fold_block import blocked_segment_fold, segment_fold
from .fused_step import (EdgeTiles, LaneEdges, build_lane_edges,
                         fused_scatter_fold, global_edges,
                         ref_fused_scatter_fold, with_lane_weights)
from .segment_combine import ref_segment_combine, segment_combine
from .spmv_block import ref_spmv_block, spmv_block


def _scope_name(kernel: str, plain: bool, device) -> str:
    route = "cuda" if not plain and torch.device(device).type == "cuda" \
        else "plain"
    return f"ppm.{kernel}.{route}"


class FoldKernel:
    """Segmented fold of the SC stream: ``(vals, valid, ids, ns) ->
    (acc, touched)``."""

    def __init__(self, monoid_name: str, plain: bool = False):
        self.monoid = monoid_name
        self.plain = plain
        # by vals.is_cuda: the stream's device picks the route
        self._obs_scope = {on_card: _scope_name(
            "fold", plain, "cuda" if on_card else "cpu")
            for on_card in (False, True)}

    def __call__(self, vals, valid, ids, num_segments):
        with kernel_scope(self._obs_scope[vals.is_cuda]):
            if self.plain:
                return segment_fold(vals, valid, ids, num_segments,
                                    self.monoid)
            return blocked_segment_fold(vals, valid, ids, num_segments,
                                        monoid=self.monoid)


def _on_device(array: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A layout array on ``device``; a dtype change happens there, not on
    the host."""
    t = torch.from_numpy(array).to(device)
    return t if dtype is None else t.to(dtype)


def _partition_tile_offsets(layout) -> np.ndarray:
    """``int64[k+1]``: destination partition ``p``'s edge tiles are
    ``[off[p], off[p+1])``.  Raises unless the tiles are destination-major,
    ``tile_first`` marks exactly each partition's first tile and the tiles
    cover the edge arrays: the precondition of the CUDA kernels that read
    the tiles by partition (``fused_dc.cu``, ``segment_combine.cu``,
    ``spmv_block.cu``)."""
    k, nt = layout.k, layout.num_edge_tiles
    dst = layout.tile_dst_part.astype(np.int64)
    if nt * layout.edge_tile != layout.num_edges:
        raise ValueError("the edge tiles do not cover the gather-order edges")
    if nt and (dst[0] < 0 or dst[-1] >= k or np.any(np.diff(dst) < 0)):
        raise ValueError("the edge tiles are not destination-major")
    off = np.searchsorted(dst, np.arange(k + 1), side="left").astype(np.int64)
    first = np.zeros(nt, dtype=bool)
    first[off[:-1][off[:-1] < off[1:]]] = True
    if not np.array_equal(first, layout.tile_first.astype(bool)):
        raise ValueError("tile_first does not mark each destination "
                         "partition's first tile")
    return off


class _TileGeometry:
    """The tile arrays of a layout on a device, shared by the three
    destination-major kernels."""

    def __init__(self, layout, device):
        self.device = torch.device(device)
        self.k, self.q, self.edge_tile = layout.k, layout.q, layout.edge_tile
        self.part_tile_off = torch.from_numpy(
            _partition_tile_offsets(layout)).to(self.device)
        self.tile_dst_part = torch.from_numpy(layout.tile_dst_part).to(
            self.device)
        self.tile_src_part = torch.from_numpy(layout.tile_src_part).to(
            self.device)
        self.tile_first = torch.from_numpy(
            layout.tile_first.astype(bool)).to(self.device)
        self.edge_dst_local = _on_device(layout.edge_dst_local, self.device)
        # [k, 1]: destination partitions that receive edge tiles
        self.has_tiles = torch.from_numpy(
            layout.part_has_tiles.astype(bool)).to(self.device)[:, None]

    def geometry(self):
        return dict(k=self.k, q=self.q, edge_tile=self.edge_tile)


def _check_edge_dst(layout, tiles: "_TileGeometry", edge_valid) -> None:
    """Raise unless every valid edge's ``edge_dst`` is ``p * q +
    edge_dst_local`` with ``edge_dst_local`` in ``[0, q)``, ``p`` its tile's
    destination partition: the per-edge part of the fused kernel's
    precondition, run once on the tiles' device."""
    q, local = tiles.q, tiles.edge_dst_local
    want = tiles.tile_dst_part.repeat_interleave(tiles.edge_tile) * q + local
    bad = (local < 0) | (local >= q)
    bad |= _on_device(layout.edge_dst, tiles.device) != want
    del want
    if bool((bad & edge_valid).any()):
        raise ValueError("a valid gather-order edge lies outside its "
                         "destination partition")


class LaneCopy:
    """A layout's arrays for the fused lane form on one device, which every
    :class:`FusedDCKernel` bound to that layout there shares
    (:func:`lane_copy`): the edges' validity and weights on the device, and
    the edge copy (:class:`LaneEdges`), built at the first lane call, and
    its weights at the first weighted one.  ``build_s`` is the time the
    builds took."""

    def __init__(self, layout, device):
        self.sources = self.sources_of(layout)
        self.edge_valid = _on_device(layout.edge_valid, device, torch.bool)
        self.edge_w = None
        self.edges = self.weighted = None
        self.build_s = 0.0

    @staticmethod
    def sources_of(layout) -> tuple:
        """The layout's arrays a copy is built from: a copy serves the
        layout while these are the same objects."""
        return (layout.edge_valid, layout.edge_w, layout.edge_src_local,
                layout.edge_dst_local, layout.tile_src_part,
                layout.tile_dst_part)

    def weights(self, layout) -> torch.Tensor:
        """``layout.edge_w`` on the device, moved there at the first call."""
        if self.edge_w is None:
            self.edge_w = _on_device(layout.edge_w, self.edge_valid.device)
        return self.edge_w

    def get(self, tiles: EdgeTiles, weighted: bool) -> LaneEdges:
        """The copy of ``tiles`` (this layout's on this device), with
        ``edge_w`` in the copy's order when ``weighted``."""
        if self.edges is None or (weighted and self.weighted is None):
            t0 = time.perf_counter()
            if self.edges is None:
                self.edges = build_lane_edges(tiles, self.edge_valid)
            if weighted:
                self.weighted = with_lane_weights(self.edges, tiles,
                                                  self.edge_w)
            if self.edge_valid.is_cuda:
                torch.cuda.synchronize(self.edge_valid.device)
            self.build_s += time.perf_counter() - t0
        return self.weighted if weighted else self.edges

    def nbytes(self) -> int:
        """The bytes the copy holds (its weights once built), each array
        once."""
        return ((self.edges.nbytes() if self.edges is not None else 0)
                + (self.weighted.w.numel() * 4 if self.weighted is not None
                   else 0))


#: (id(layout), device) -> its LaneCopy, dropped with the layout
_LANE_COPIES = {}


def lane_copy(layout, device) -> LaneCopy:
    """The :class:`LaneCopy` of ``layout`` on ``device``: one a layout and
    device, kept as long as the layout lives, and made anew where one of
    the layout's arrays it was built from was replaced."""
    device = torch.device(device)
    key = (id(layout), device.type, device.index)
    copy = _LANE_COPIES.get(key)
    if copy is None:
        weakref.finalize(layout, _LANE_COPIES.pop, key, None)
    if copy is None or any(
            a is not b for a, b in zip(copy.sources,
                                       LaneCopy.sources_of(layout))):
        copy = _LANE_COPIES[key] = LaneCopy(layout, device)
    return copy


class FusedDCKernel(_TileGeometry):
    """Fused DC scatter→fold bound to a layout: ``(table, table_valid) ->
    (acc, touched)`` over ``[n_pad + 1]`` (or ``[B, n_pad + 1]``).

    The CUDA kernel reads the layout's tile form (:class:`EdgeTiles`), so
    binding a layout moves its tile arrays to the device and checks the
    kernel's precondition there (per tile on the host, per edge on the
    device): no per-edge array is built on the host.  The plain route (the
    CPU, or ``plain=True``) builds the reference's global ``idx`` and
    ``dst`` from the tiles on the device (:func:`global_edges`).

    ``apply_weight`` is engine-configured:
    :class:`repro_torch.core.engine.Engine` passes it, under the same
    condition the reference applies it, and the layout's weights go to the
    device only then.

    The lane form on a card reads :class:`LaneEdges`, built on the card at
    the first ``[B, M]`` call (:meth:`lane_edges`) and kept, with the
    validity and weights it was built from, in the layout's
    :class:`LaneCopy` (``lane_copy``), which every kernel bound to the
    layout on this device shares."""

    def __init__(self, layout, monoid_name: str, dtype: torch.dtype,
                 device, plain: bool = False, apply_weight=None):
        super().__init__(layout, device)
        self.monoid = monoid_name
        self.dtype = dtype
        self.plain = plain
        self.n_pad = layout.n_pad
        self.edge_src_local = _on_device(layout.edge_src_local, self.device)
        self.lane_copy = lane_copy(layout, self.device)
        self.edge_valid = self.lane_copy.edge_valid
        _check_edge_dst(layout, self, self.edge_valid)
        self.apply_weight = apply_weight
        self.edge_w = (self.lane_copy.weights(layout)
                       if apply_weight is not None else None)
        self.tiles = EdgeTiles(self.edge_src_local, self.edge_dst_local,
                               self.tile_src_part, self.part_tile_off,
                               self.q, self.edge_tile)
        self._obs_scope = _scope_name("fused_dc", plain, self.device)
        self.edge_src = self.edge_dst = None     # the plain route's idx, dst
        if plain or self.device.type == "cpu":
            self.edge_src, self.edge_dst = global_edges(
                self.tile_src_part, self.tile_dst_part, self.edge_src_local,
                self.edge_dst_local, self.edge_valid, q=self.q,
                edge_tile=self.edge_tile, n_pad=self.n_pad)

    def lane_edges(self) -> LaneEdges:
        """The lane form's edge copy of this layout (with ``edge_w`` when an
        edge function applies), from the layout's :class:`LaneCopy`."""
        return self.lane_copy.get(self.tiles, self.apply_weight is not None)

    def __call__(self, table, table_valid):
        aw = self.apply_weight
        w = self.edge_w if aw is not None else None
        with kernel_scope(self._obs_scope):
            if self.plain:
                return ref_fused_scatter_fold(
                    M.make(self.monoid, self.dtype), table, table_valid,
                    self.edge_src, self.edge_valid, self.edge_dst,
                    self.n_pad + 1, apply_weight=aw, w=w)
            lanes = table.dim() == 2 and table.is_cuda
            return fused_scatter_fold(
                table, table_valid, self.edge_src, self.edge_valid,
                self.edge_dst, self.n_pad + 1, monoid=self.monoid,
                tiles=self.tiles, apply_weight=aw, w=w,
                lane_edges=self.lane_edges() if lanes else None)


class FusedStreamKernel:
    """Layout-free fused gather→fold: ``(table, table_valid, idx,
    edge_valid, dst, num_segments, w=None, apply_weight=None, parts=None)
    -> (acc, touched)``, the :func:`fused_scatter_fold` contract on one
    ``[M]`` table.

    What :class:`FoldKernel` is to the fold, this is to the fused step: the
    distributed engine's receive table (``rv[slot]``) has no tile
    structure, so each call takes the table, the slot indices and the
    static validity, and one launch of ``csrc/fused_stream.cu`` fuses the
    slot gather, the edge function and the fold; ``parts`` (the engine's
    :class:`repro_torch.kernels.fused_step.PartRanges`) selects its
    partitioned regime.  The route follows the table's device (the plain
    version on the CPU, which ignores ``parts``) unless ``plain=True``."""

    def __init__(self, monoid_name: str, dtype: torch.dtype,
                 plain: bool = False):
        self.monoid = monoid_name
        self.dtype = dtype
        self.plain = plain
        self._obs_scope = {on_card: _scope_name(
            "fused_dc", plain, "cuda" if on_card else "cpu")
            for on_card in (False, True)}

    def __call__(self, table, table_valid, idx, edge_valid, dst,
                 num_segments, w=None, apply_weight=None, parts=None):
        with kernel_scope(self._obs_scope[table.is_cuda]):
            if self.plain:
                return ref_fused_scatter_fold(
                    M.make(self.monoid, self.dtype), table, table_valid, idx,
                    edge_valid, dst, int(num_segments),
                    apply_weight=apply_weight, w=w)
            return fused_scatter_fold(
                table, table_valid, idx, edge_valid, dst, int(num_segments),
                monoid=self.monoid, apply_weight=apply_weight, w=w,
                parts=parts)


class GatherKernel(_TileGeometry):
    """Gather-phase fold of the composed DC path bound to a layout:
    ``(edge_vals, edge_valid, part_active) -> (acc, touched)`` over
    ``[n_pad]`` (``[B, NE]``, ``[B, NE]``, ``[B, k]`` -> ``[B, n_pad]`` for
    B lanes).  A destination partition with no tiles gets the identity and
    is untouched, as in the reference."""

    def __init__(self, layout, monoid_name: str, dtype: torch.dtype, device,
                 plain: bool = False):
        super().__init__(layout, device)
        self.monoid = monoid_name
        self.plain = plain
        self.ident = M.full((1, 1), M.identity_value(monoid_name, dtype),
                            dtype, self.device)
        self._obs_scope = _scope_name("gather", plain, self.device)

    def __call__(self, edge_vals, edge_valid, part_active):
        with kernel_scope(self._obs_scope):
            part_active = torch.as_tensor(part_active,
                                          device=self.device).to(torch.bool)
            args = (edge_vals, edge_valid, self.edge_dst_local,
                    self.tile_dst_part, self.tile_src_part, self.tile_first,
                    part_active)
            if self.plain:
                acc, touched = ref_segment_combine(
                    *args, monoid=self.monoid, **self.geometry())
            else:
                acc, touched = segment_combine(
                    *args, monoid=self.monoid,
                    part_tile_off=self.part_tile_off, **self.geometry())
            acc = M.where(self.has_tiles, acc, self.ident)
            touched = touched & self.has_tiles
            flat = acc.shape[:-2] + (-1,)
            return acc.reshape(flat), touched.reshape(flat)


class ScatterKernel:
    """DC scatter of the composed path bound to a layout: ``(x_flat,
    active_flat) -> [NM]`` message bins (``[B, n_pad]`` inputs -> ``[B,
    NM]`` for B lanes).

    On a card, binding the layout also cuts its slot tiles into the CUDA
    kernel's staged pieces (:func:`dc_pieces`, host NumPy over the
    ``[NM / msg_tile]`` tile partitions, one per SM of the card or per
    source partition); ``pieces`` stays None where the plain version runs
    or the layout's runs are too short to stage."""

    def __init__(self, layout, monoid_name: str, dtype: torch.dtype, device,
                 plain: bool = False):
        self.device = torch.device(device)
        self.monoid = monoid_name
        self.dtype = dtype
        self.plain = plain
        self.k, self.q, self.msg_tile = layout.k, layout.q, layout.msg_tile
        self.png_src_local = torch.from_numpy(layout.png_src_local).to(
            self.device)
        self.png_valid = torch.from_numpy(
            layout.png_src < layout.n_pad).to(self.device)
        self.png_tile_part = torch.from_numpy(layout.png_tile_part).to(
            self.device)
        self._obs_scope = _scope_name("scatter", plain, self.device)
        self.pieces = None
        if not plain and self.device.type == "cuda":
            sms = torch.cuda.get_device_properties(
                self.device).multi_processor_count
            off = dc_pieces(layout.png_tile_part, q=self.q,
                            msg_tile=self.msg_tile, blocks=sms,
                            value_bytes=dtype.itemsize)
            if off is not None:
                self.pieces = torch.from_numpy(off).to(self.device)

    def __call__(self, x_flat, active_flat):
        with kernel_scope(self._obs_scope):
            grid = x_flat.shape[:-1] + (self.k, self.q)
            x = x_flat.to(self.dtype).reshape(grid)
            active = active_flat.to(torch.bool).reshape(grid)
            args = (x, active, self.png_src_local, self.png_valid,
                    self.png_tile_part)
            geo = dict(k=self.k, q=self.q, msg_tile=self.msg_tile,
                       monoid=self.monoid)
            if self.plain:
                return ref_dc_gather(*args, **geo)
            return dc_gather(*args, **geo, pieces=self.pieces)


class SpmvKernel(_TileGeometry):
    """Partition-centric f32 SpMV bound to a layout: ``x_flat -> y_flat``
    over ``[n_pad]``, 0 on destination partitions with no tiles.
    ``weighted=None`` takes the layout's own."""

    def __init__(self, layout, device, weighted=None, plain: bool = False):
        super().__init__(layout, device)
        self.plain = plain
        self.weighted = layout.weighted if weighted is None else weighted
        self.edge_src_local = torch.from_numpy(layout.edge_src_local).to(
            self.device)
        self.edge_valid = torch.from_numpy(
            layout.edge_valid.astype(bool)).to(self.device)
        self.edge_w = (torch.from_numpy(layout.edge_w).to(self.device)
                       if self.weighted and layout.edge_w is not None
                       else None)
        self._obs_scope = _scope_name("spmv", plain, self.device)

    def __call__(self, x_flat):
        with kernel_scope(self._obs_scope):
            args = (x_flat.reshape(self.k, self.q), self.edge_src_local,
                    self.edge_dst_local, self.edge_valid, self.edge_w,
                    self.tile_dst_part, self.tile_src_part, self.tile_first)
            weighted = self.edge_w is not None
            if self.plain:
                y = ref_spmv_block(*args, weighted=weighted,
                                   **self.geometry())
            else:
                y = spmv_block(*args, weighted=weighted,
                               part_tile_off=self.part_tile_off,
                               **self.geometry())
            return torch.where(self.has_tiles, y, 0.0).reshape(-1)

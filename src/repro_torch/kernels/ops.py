"""Engine-facing wrappers around the port's two kernels.

Counterparts of ``FoldKernel`` and ``FusedDCKernel`` in
:mod:`repro.kernels.ops`.  :class:`FusedDCKernel` binds a layout once: it
moves the gather-order edge arrays to the engine's device and checks, on the
host, the precondition of the CUDA fused kernel.

Both take ``plain=True`` to run the plain PyTorch versions on any device;
``chip_smoke.py`` uses that to hold a whole app run on the card against the
kernels.  Otherwise the device of the tensors decides: the plain version on
the CPU, the CUDA kernel on a card.  The launch counts live with the kernels
(:data:`repro_torch.kernels._build.FUSED_DC` and ``SEGMENT_FOLD``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from .fold_block import blocked_segment_fold, segment_fold
from .fused_step import fused_scatter_fold, ref_fused_scatter_fold


class FoldKernel:
    """Segmented fold of the SC stream: ``(vals, valid, ids, ns) ->
    (acc, touched)``."""

    def __init__(self, monoid_name: str, plain: bool = False):
        self.monoid = monoid_name
        self.plain = plain

    def __call__(self, vals, valid, ids, num_segments):
        if self.plain:
            return segment_fold(vals, valid, ids, num_segments, self.monoid)
        return blocked_segment_fold(vals, valid, ids, num_segments,
                                    monoid=self.monoid)


def _edge_src_global(layout) -> np.ndarray:
    """Per-edge *global* source vertex of the gather-order edge stream.

    Every edge tile lies inside one ``(p', p)`` block, so the tile's
    source partition base plus the per-edge local offset recovers the
    global id — the index the fused kernel gathers the message table with
    (clamped into the sentinel for pad tiles)."""
    base = np.repeat(layout.tile_src_part.astype(np.int64),
                     layout.edge_tile) * layout.q
    src = base + layout.edge_src_local.astype(np.int64)
    return np.clip(src, 0, layout.n_pad).astype(np.int32)


def _partition_edge_offsets(layout) -> np.ndarray:
    """``int64[k+1]``: destination partition ``p``'s gather-order edges are
    ``[off[p], off[p+1])``; raises unless every valid edge's ``dst`` lies in
    its partition, the CUDA fused kernel's precondition."""
    k, q = layout.k, layout.q
    off = np.asarray(layout.blk_off[::k], dtype=np.int64)
    if len(off) != k + 1 or off[-1] != layout.num_edges:
        raise ValueError("blk_off does not cover the gather-order edges")
    part = np.repeat(np.arange(k, dtype=np.int64), np.diff(off))
    valid = layout.edge_valid.astype(bool)
    if np.any(layout.edge_dst[valid].astype(np.int64) // q != part[valid]):
        raise ValueError("a valid gather-order edge lies outside its "
                         "destination partition")
    return off


class FusedDCKernel:
    """Fused DC scatter→fold bound to a layout.

    ``apply_weight`` is engine-configured: :class:`repro_torch.core.engine.Engine`
    sets it once, under the same condition the reference applies it."""

    def __init__(self, layout, monoid_name: str, dtype: torch.dtype,
                 device, plain: bool = False):
        self.monoid = monoid_name
        self.dtype = dtype
        self.plain = plain
        self.n_pad = layout.n_pad
        self.q = layout.q
        self.part_off = torch.from_numpy(
            _partition_edge_offsets(layout)).to(device)
        self.edge_src = torch.from_numpy(_edge_src_global(layout)).to(device)
        self.edge_valid = torch.from_numpy(
            layout.edge_valid.astype(bool)).to(device)
        self.edge_dst = torch.from_numpy(
            layout.edge_dst.astype(np.int32)).to(device)
        self.edge_w = (torch.from_numpy(layout.edge_w).to(device)
                       if layout.edge_w is not None else None)
        self.apply_weight = None               # engine-configured

    def __call__(self, table, table_valid):
        aw = self.apply_weight
        w = self.edge_w if aw is not None else None
        if self.plain:
            return ref_fused_scatter_fold(
                M.REGISTRY[self.monoid](self.dtype), table, table_valid,
                self.edge_src, self.edge_valid, self.edge_dst,
                self.n_pad + 1, apply_weight=aw, w=w)
        return fused_scatter_fold(
            table, table_valid, self.edge_src, self.edge_valid,
            self.edge_dst, self.n_pad + 1, monoid=self.monoid,
            part_off=self.part_off, q=self.q, apply_weight=aw, w=w)

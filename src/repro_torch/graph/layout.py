"""Partition-centric graph layout (paper §3.1-3.3).

Builds the static data structures PPM needs:

  * index-based partitioning: partition ``p`` owns vertices
    ``[p*q, (p+1)*q)`` (paper §3.1);
  * the 2D block grid of bins: edges bucketed by
    ``(src_partition, dst_partition)`` (paper §3.2, Fig. 3).  *Message slots*
    (the scatter-side ``data_bin``) are laid out row-major — partition ``p``
    writes its whole bin row contiguously, as in the paper's Scatter phase.
    *Edges* (the gather-side ``dc_bin``: pre-written adjacency) are laid out
    column-major — partition ``p'`` reads its whole bin column contiguously,
    as in the paper's Gather phase;
  * the PNG (Partition-Node bipartite Graph) layout for destination-centric
    scatter: one message slot per (src vertex, dst partition) pair; the wire
    carries values only (§3.3);
  * per-partition constants for the Eq. 1 communication cost model.

Edge blocks and message blocks are padded to tile multiples.  The CUDA fused
DC kernel gives one thread block to each destination partition and reads that
partition's contiguous edge range ``[blk_off[p'*k], blk_off[(p'+1)*k])``.

A NumPy copy of :mod:`repro.graph.layout`: the same arrays, field for field.
Unset tiles resolve through the port's tuning cache
(:func:`repro_torch.backend.tuning.resolve_geometry`), with the
``REPRO_FOLD_TILE`` / ``REPRO_FOLD_Q`` knobs outranking it, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .csr import Graph


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult if mult > 1 else x


def _pad_to_array(x: np.ndarray, mult: int) -> np.ndarray:
    if mult <= 1:
        return x.astype(np.int64)
    return (((x + mult - 1) // mult) * mult).astype(np.int64)


@dataclasses.dataclass
class Layout:
    """Static partition-centric layout for a graph.

    Vertex space is padded to ``n_pad = k*q``; the sentinel vertex id is
    ``n_pad`` and the sentinel message slot is ``num_msgs`` (identity-valued).
    """

    # ---- partitioning ----
    k: int                    # number of partitions
    q: int                    # vertices per partition
    n: int                    # real vertex count
    m: int                    # real edge count
    weighted: bool

    # ---- PNG / message slots (scatter side), row-major (p, p', src) ----
    png_src: np.ndarray       # int32[NM] global src id per slot (sentinel n_pad)
    png_src_local: np.ndarray  # int32[NM] src id within its partition (0 on pads)
    png_off: np.ndarray       # int64[k*k+1] slot offsets, block key = p*k + p'
    png_tile_part: np.ndarray  # int32[NM/msg_tile] src partition per slot tile

    # ---- dc_bin: gather-side edge arrays, column-major (p', p, src, dst) ----
    msg_slot: np.ndarray      # int32[NE] message slot per edge (sentinel NM)
    edge_dst: np.ndarray      # int32[NE] global dst id (sentinel n_pad)
    edge_src_local: np.ndarray  # int32[NE] src id within src partition (0 pads)
    edge_dst_local: np.ndarray  # int32[NE] dst id within dst partition (0 pads)
    edge_valid: np.ndarray    # bool[NE] real edge?
    edge_w: Optional[np.ndarray]   # float32[NE] | None
    blk_off: np.ndarray       # int64[k*k+1] edge offsets, block key = p'*k + p

    # ---- per-edge-tile metadata (kernel blocking + predication) ----
    edge_tile: int
    msg_tile: int
    fold_tile: int            # message-tile of the blocked segmented fold
    fold_q: int               # bucket width of the two-level (over-cap) fold
    tile_src_part: np.ndarray  # int32[NT] source partition of each edge tile
    tile_dst_part: np.ndarray  # int32[NT] destination partition (non-decreasing)
    tile_first: np.ndarray     # bool[NT] first tile of its destination partition
    part_has_tiles: np.ndarray  # bool[k] destination partition receives edges

    # ---- original CSR (source-centric frontier expansion) ----
    csr_indptr: np.ndarray    # int64[n_pad + 2] (sentinel row n_pad: degree 0)
    csr_indices: np.ndarray   # int32[m]
    csr_w: Optional[np.ndarray]

    # ---- per-partition constants (Eq. 1) ----
    part_edges: np.ndarray    # int64[k]  E^p (out-edges of partition p)
    part_msgs: np.ndarray     # int64[k]  r*E^p = PNG slots of p
    deg: np.ndarray           # int64[n_pad] out-degree (0 on pads)

    @property
    def n_pad(self) -> int:
        return self.k * self.q

    @property
    def num_msgs(self) -> int:
        return len(self.png_src)

    @property
    def num_edges(self) -> int:
        return len(self.msg_slot)

    @property
    def num_edge_tiles(self) -> int:
        return len(self.tile_src_part)

    def part_of(self, v):
        return v // self.q

    # -- Eq. 1 cost model constants (bytes; d_i = d_v = 4 as in the paper) --
    def dc_cost_bytes(self, d_i: int = 4, d_v: int = 4) -> np.ndarray:
        """Per-partition DC bytes: rE^p*d_i + k*d_i + 2rE^p*d_v + E^p*d_i."""
        return (self.part_msgs * d_i + self.k * d_i
                + 2 * self.part_msgs * d_v + self.part_edges * d_i)

    def sc_cost_coeff(self, d_i: int = 4, d_v: int = 4) -> np.ndarray:
        """Per-active-edge SC bytes: 2r*d_v + 3*d_i (paper's approximation)."""
        r = self.part_msgs / np.maximum(self.part_edges, 1)
        return 2.0 * r * d_v + 3.0 * d_i


def resolve_k(n: int, k: Optional[int] = None, parallel_units: int = 8,
              cache_vertices: Optional[int] = None) -> int:
    """The paper's §3.1 partition-count rule: enough partitions that one
    partition's vertex data fits the private cache (``cache_vertices``),
    and ``k >= 4 * parallel_units``; clamped to [1, n]."""
    if k is None:
        k = max(4 * parallel_units, 1)
        if cache_vertices is not None:
            k = max(k, -(-n // cache_vertices))
    return max(1, min(k, max(1, n)))


def build_layout(g: Graph, k: Optional[int] = None,
                 parallel_units: int = 8,
                 q_mult: int = 8,
                 edge_tile: Optional[int] = None,
                 msg_tile: Optional[int] = None,
                 fold_tile: Optional[int] = None,
                 fold_q: Optional[int] = None,
                 cache_vertices: Optional[int] = None) -> Layout:
    """Build the partition-centric layout.

    ``k`` defaults to the paper's rule (§3.1), see :func:`resolve_k`.

    ``edge_tile``/``msg_tile``/``fold_tile``/``fold_q`` left unset resolve
    through the :mod:`repro_torch.backend.tuning` cache: an ``autotune()``
    sweep recorded for this platform and graph family wins, otherwise the
    static defaults (256/128/256/256) apply.  ``fold_tile`` and ``fold_q``
    honour the ``REPRO_FOLD_TILE`` / ``REPRO_FOLD_Q`` knobs first.
    """
    n, m = g.n, g.m
    k = resolve_k(n, k, parallel_units, cache_vertices)
    if edge_tile is None or msg_tile is None or fold_tile is None \
            or fold_q is None:
        import os

        from ..backend.tuning import resolve_geometry
        from ..kernels.fold_block import ENV_FOLD_TILE, default_fold_tile
        from ..kernels.fold_two_level import ENV_FOLD_Q, default_fold_q
        geom = resolve_geometry(n, m, k, weighted=g.weighted)
        edge_tile = geom.edge_tile if edge_tile is None else edge_tile
        msg_tile = geom.msg_tile if msg_tile is None else msg_tile
        # the knobs outrank the tuned or static geometry, so an operator
        # can steer a deployed layout without a new sweep
        if fold_tile is None:
            fold_tile = (default_fold_tile() if os.environ.get(ENV_FOLD_TILE)
                         else geom.fold_tile)
        if fold_q is None:
            fold_q = (default_fold_q() if os.environ.get(ENV_FOLD_Q)
                      else geom.fold_q)
    q = _pad_to(-(-n // k), q_mult)
    n_pad = k * q

    src = np.repeat(np.arange(n, dtype=np.int64), g.out_degrees())
    dst = g.indices.astype(np.int64)
    w = g.weights
    sp = src // q
    dp = dst // q

    # --- scatter-side (row-major) sort: (p, p', src, dst) ---
    sblk = sp * k + dp
    order_s = np.argsort(sblk, kind="stable")      # CSR input is (src,dst)-sorted
    src, dst, sblk = src[order_s], dst[order_s], sblk[order_s]
    sp, dp = sp[order_s], dp[order_s]
    if w is not None:
        w = w[order_s]

    # message slots: one per unique (src, dst-partition) pair
    new_slot = np.ones(m, dtype=bool)
    if m > 1:
        same = (src[1:] == src[:-1]) & (sblk[1:] == sblk[:-1])
        new_slot[1:] = ~same
    slot_of_edge = np.cumsum(new_slot) - 1
    num_msgs = int(slot_of_edge[-1] + 1) if m else 0
    slot_src = src[new_slot]
    slot_blk = sblk[new_slot]

    blk_msg_cnt = np.bincount(slot_blk, minlength=k * k)
    blk_msg_pad = _pad_to_array(blk_msg_cnt, msg_tile)
    png_off = np.concatenate([[0], np.cumsum(blk_msg_pad)])
    nm_pad = int(png_off[-1])
    slot_rank = np.arange(num_msgs) - np.repeat(
        np.concatenate([[0], np.cumsum(blk_msg_cnt)])[:-1], blk_msg_cnt)
    spos = png_off[slot_blk] + slot_rank          # padded slot position
    slot_pad_of_edge = spos[slot_of_edge]

    png_src = np.full(nm_pad, n_pad, dtype=np.int32)
    png_src[spos] = slot_src
    png_src_local = np.zeros(nm_pad, dtype=np.int32)
    png_src_local[spos] = slot_src - (slot_src // q) * q
    if nm_pad:
        png_tile_part = (png_src.reshape(-1, msg_tile)[:, 0] * 0)  # placeholder
        # slot tiles lie inside one block (blocks padded to msg_tile)
        ntm = nm_pad // msg_tile
        tile_blk_m = np.searchsorted(png_off[1:], np.arange(ntm) * msg_tile,
                                     side="right")
        png_tile_part = (tile_blk_m // k).astype(np.int32)
    else:
        png_tile_part = np.zeros(0, dtype=np.int32)

    # --- gather-side (column-major) sort: (p', p, src, dst) ---
    dblk = dp * k + sp
    order_d = np.argsort(dblk, kind="stable")
    src_d, dst_d, dblk_s = src[order_d], dst[order_d], dblk[order_d]
    slot_pad_d = slot_pad_of_edge[order_d]
    w_d = w[order_d] if w is not None else None

    blk_edge_cnt = np.bincount(dblk_s, minlength=k * k)
    blk_edge_pad = _pad_to_array(blk_edge_cnt, edge_tile)
    blk_off = np.concatenate([[0], np.cumsum(blk_edge_pad)])
    ne_pad = int(blk_off[-1])
    edge_rank = np.arange(m) - np.repeat(
        np.concatenate([[0], np.cumsum(blk_edge_cnt)])[:-1], blk_edge_cnt)
    epos = blk_off[dblk_s] + edge_rank

    msg_slot = np.full(ne_pad, nm_pad, dtype=np.int32)
    msg_slot[epos] = slot_pad_d
    edge_dst = np.full(ne_pad, n_pad, dtype=np.int32)
    edge_dst[epos] = dst_d
    edge_src_local = np.zeros(ne_pad, dtype=np.int32)
    edge_src_local[epos] = src_d - (src_d // q) * q
    edge_dst_local = np.zeros(ne_pad, dtype=np.int32)
    edge_dst_local[epos] = dst_d - (dst_d // q) * q
    edge_valid = np.zeros(ne_pad, dtype=bool)
    edge_valid[epos] = True
    edge_w = None
    if w_d is not None:
        edge_w = np.zeros(ne_pad, dtype=np.float32)
        edge_w[epos] = w_d

    # per-tile metadata (each tile lies inside exactly one block)
    nt = ne_pad // edge_tile
    tile_blk = np.searchsorted(blk_off[1:], np.arange(nt) * edge_tile,
                               side="right")
    tile_dst_part = (tile_blk // k).astype(np.int32)
    tile_src_part = (tile_blk % k).astype(np.int32)
    tile_first = np.ones(nt, dtype=bool)
    tile_first[1:] = tile_dst_part[1:] != tile_dst_part[:-1]
    part_has_tiles = np.zeros(k, dtype=bool)
    part_has_tiles[tile_dst_part] = True

    # CSR with sentinel row (vertex n_pad: degree 0) for SC expansion
    csr_indptr = np.zeros(n_pad + 2, dtype=np.int64)
    csr_indptr[1:n + 1] = g.indptr[1:]
    csr_indptr[n + 1:] = m

    part_edges = np.zeros(k, dtype=np.int64)
    np.add.at(part_edges, sp, 1)
    part_msgs = np.zeros(k, dtype=np.int64)
    np.add.at(part_msgs, slot_blk // k, 1)
    deg = np.zeros(n_pad, dtype=np.int64)
    deg[:n] = g.out_degrees()

    return Layout(
        k=k, q=q, n=n, m=m, weighted=g.weighted,
        png_src=png_src, png_src_local=png_src_local, png_off=png_off,
        png_tile_part=png_tile_part,
        msg_slot=msg_slot, edge_dst=edge_dst,
        edge_src_local=edge_src_local, edge_dst_local=edge_dst_local,
        edge_valid=edge_valid, edge_w=edge_w, blk_off=blk_off,
        edge_tile=edge_tile, msg_tile=msg_tile, fold_tile=fold_tile,
        fold_q=fold_q,
        tile_src_part=tile_src_part, tile_dst_part=tile_dst_part,
        tile_first=tile_first, part_has_tiles=part_has_tiles,
        csr_indptr=csr_indptr, csr_indices=g.indices.astype(np.int32),
        csr_w=g.weights,
        part_edges=part_edges, part_msgs=part_msgs, deg=deg,
    )

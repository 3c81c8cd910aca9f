"""Dynamic-graph deltas over the partition-centric layout.

GPOP's partition structure is the natural delta unit: a :class:`DeltaBuffer`
accumulates edge insertions/deletions bucketed by *destination partition*
(the gather-side bin column the edit lands in), and :func:`apply_delta`
rebuilds only the bins owned by dirty *source* partitions — every (p, p')
block with a clean source partition p keeps its CSR rows, its PNG slot row
and its gather-column content byte-for-byte, so per-partition content tags
(and the semantic-cache entries keyed on them) survive the edit.

Semantics
---------
The buffer edits the *edge set* of a fixed vertex set:

  * ``insert(u, v, w)`` adds edge ``(u, v)`` (or overwrites its weight if it
    already exists);
  * ``delete(u, v)`` removes ``(u, v)`` if present (a no-op otherwise);
  * the last operation on a given ``(u, v)`` wins;
  * the vertex set never changes — deltas edit edges only, so ``k``/``q``
    and the partition map are stable across :func:`apply_delta` (that
    stability is what makes per-partition reuse and scoped cache
    invalidation possible at all).

Parallel duplicate edges inside a *dirty* partition are collapsed by an
edit that touches their ``(u, v)`` key; untouched duplicates in clean
partitions are preserved verbatim.

Equivalence contract
--------------------
``apply_delta(layout, delta)`` is bit-exact equal to
``build_layout(delta.edit_graph(g), k=layout.k, ...)`` with the old
layout's tile geometry — every array field, including pad sentinels.

A NumPy copy of :mod:`repro.graph.delta` over the port's
:mod:`repro_torch.graph.layout`; ``tests/test_torch_delta.py`` holds it
array for array against the original and against a full rebuild.  The
relayout is host work, as in the reference.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from .. import obs
from .csr import Graph, from_edges
from .layout import Layout, _pad_to_array

__all__ = ["DeltaBuffer", "apply_delta"]

_INS = "+"
_DEL = "-"


def _as_1d_int(x) -> np.ndarray:
    a = np.atleast_1d(np.asarray(x, dtype=np.int64))
    if a.ndim != 1:
        raise ValueError(f"expected scalar or 1-D vertex ids, got shape {a.shape}")
    return a


class DeltaBuffer:
    """Edge insertions/deletions against one layout's partitioning.

    Operations are bucketed by destination partition ``dst // q`` — the
    bin column the edit lands in.  ``for_layout`` is the usual
    constructor; the buffer validates every endpoint against ``n`` (the
    vertex set is fixed; grow it with a full ``build_layout``).
    """

    def __init__(self, k: int, q: int, n: int):
        if k <= 0 or q < 0 or n < 0 or n > k * q:
            raise ValueError(f"inconsistent partitioning k={k} q={q} n={n}")
        self.k = int(k)
        self.q = int(q)
        self.n = int(n)
        # dst-partition buckets: dp -> {(u, v): ("+", w) | ("-", None)}
        self._buckets: Dict[int, Dict[Tuple[int, int], Tuple[str, Optional[float]]]] = {}

    @classmethod
    def for_layout(cls, layout: Layout) -> "DeltaBuffer":
        return cls(layout.k, layout.q, layout.n)

    # ---- mutation ----

    def _check(self, src: np.ndarray, dst: np.ndarray) -> None:
        for name, a in (("src", src), ("dst", dst)):
            if a.size and (a.min() < 0 or a.max() >= self.n):
                raise ValueError(
                    f"{name} id out of range [0, {self.n}) — deltas edit "
                    f"edges over a fixed vertex set")

    def _put(self, u: int, v: int, op: Tuple[str, Optional[float]]) -> None:
        dp = v // self.q if self.q else 0
        self._buckets.setdefault(dp, {})[(u, v)] = op

    def insert(self, src, dst, w=None) -> "DeltaBuffer":
        """Queue edge insertions (scalars or equal-length arrays)."""
        su, sv = _as_1d_int(src), _as_1d_int(dst)
        if su.shape != sv.shape:
            raise ValueError("src/dst length mismatch")
        self._check(su, sv)
        if w is None:
            ws = [None] * len(su)
        else:
            wa = np.atleast_1d(np.asarray(w, dtype=np.float32))
            if wa.shape != su.shape:
                raise ValueError("weights length mismatch")
            ws = [float(x) for x in wa]
        for u, v, wi in zip(su.tolist(), sv.tolist(), ws):
            self._put(u, v, (_INS, wi))
        return self

    def delete(self, src, dst) -> "DeltaBuffer":
        """Queue edge deletions (scalars or equal-length arrays)."""
        su, sv = _as_1d_int(src), _as_1d_int(dst)
        if su.shape != sv.shape:
            raise ValueError("src/dst length mismatch")
        self._check(su, sv)
        for u, v in zip(su.tolist(), sv.tolist()):
            self._put(u, v, (_DEL, None))
        return self

    # ---- inspection ----

    def _iter_ops(self) -> Iterable[Tuple[int, int, str, Optional[float]]]:
        for dp in sorted(self._buckets):
            for (u, v), (op, w) in self._buckets[dp].items():
                yield u, v, op, w

    def __len__(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def __bool__(self) -> bool:
        return any(self._buckets.values())

    @property
    def num_inserts(self) -> int:
        return sum(1 for *_ignored, op, _w in self._iter_ops() if op == _INS)

    @property
    def num_deletes(self) -> int:
        return len(self) - self.num_inserts

    @property
    def insertions_only(self) -> bool:
        """True iff the delta only adds/overwrites edges — the case where
        an old converged min-monoid state stays a pointwise upper bound of
        the new fixpoint (so warm resume and landmark migration are sound;
        deletions can *raise* distances and need a cold start)."""
        return self.num_deletes == 0

    def inserts(self):
        """(src, dst, w|None) int64/int64/float32 arrays, (src, dst)-sorted."""
        rows = [(u, v, w) for u, v, op, w in self._iter_ops() if op == _INS]
        rows.sort()
        src = np.array([r[0] for r in rows], dtype=np.int64)
        dst = np.array([r[1] for r in rows], dtype=np.int64)
        if any(r[2] is not None for r in rows):
            w = np.array([1.0 if r[2] is None else r[2] for r in rows],
                         dtype=np.float32)
        else:
            w = None
        return src, dst, w

    def deletes(self):
        """(src, dst) int64 arrays, (src, dst)-sorted."""
        rows = sorted((u, v) for u, v, op, _w in self._iter_ops()
                      if op == _DEL)
        return (np.array([r[0] for r in rows], dtype=np.int64),
                np.array([r[1] for r in rows], dtype=np.int64))

    def src_partitions(self) -> np.ndarray:
        """Partitions whose out-rows (CSR + scatter/gather bins) change."""
        parts = {u // self.q if self.q else 0
                 for u, _v, _op, _w in self._iter_ops()}
        return np.array(sorted(parts), dtype=np.int32)

    def dst_partitions(self) -> np.ndarray:
        """The destination-partition bucket keys holding queued ops."""
        return np.array(sorted(dp for dp, b in self._buckets.items() if b),
                        dtype=np.int32)

    def dirty_partitions(self) -> np.ndarray:
        """Partitions owning either endpoint of any queued op — the scope
        of cache invalidation (a partition's converged state can change
        when either its out-edges or its in-edges do)."""
        parts = set()
        for u, v, _op, _w in self._iter_ops():
            if self.q:
                parts.add(u // self.q)
                parts.add(v // self.q)
            else:
                parts.add(0)
        return np.array(sorted(parts), dtype=np.int32)

    def touched(self) -> np.ndarray:
        """bool[n_pad] mask of delta endpoints — the initial frontier for
        incremental recompute (``Engine.run(resume_from=, touched=)``)."""
        mask = np.zeros(self.k * self.q, dtype=bool)
        for u, v, _op, _w in self._iter_ops():
            mask[u] = True
            mask[v] = True
        return mask

    # ---- reference edit (full-rebuild baseline) ----

    def edit_graph(self, g: Graph) -> Graph:
        """Apply the buffered ops to ``g`` and return the edited graph —
        the reference for the full-rebuild baseline
        (``build_layout(delta.edit_graph(g), ...)``)."""
        if g.n != self.n:
            raise ValueError(f"graph has n={g.n}, buffer built for n={self.n}")
        n = self.n
        src = np.repeat(np.arange(n, dtype=np.int64), g.out_degrees())
        dst = g.indices.astype(np.int64)
        w = g.weights
        ins_src, ins_dst, ins_w = self.inserts()
        del_src, del_dst = self.deletes()
        nk = max(n, 1)
        drop_keys = np.concatenate([ins_src * nk + ins_dst,
                                    del_src * nk + del_dst])
        keep = ~np.isin(src * nk + dst, drop_keys)
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
        new_src = np.concatenate([src, ins_src])
        new_dst = np.concatenate([dst, ins_dst])
        weights = None
        if g.weighted:
            if len(ins_src) and ins_w is None:
                raise ValueError("weighted graph: insert() needs weights")
            ins_w = (ins_w if ins_w is not None
                     else np.zeros(0, dtype=np.float32))
            weights = np.concatenate([w, ins_w])
        return from_edges(new_src, new_dst, n=n, weights=weights)


def _partition_edges(layout: Layout, p: int):
    """(src, dst, w) of partition ``p``'s out-edges from the layout CSR,
    in (src, dst) order."""
    q, n = layout.q, layout.n
    vs, ve = min(p * q, n), min((p + 1) * q, n)
    e0 = int(layout.csr_indptr[vs])
    e1 = int(layout.csr_indptr[ve])
    degs = np.diff(layout.csr_indptr[vs:ve + 1])
    src = np.repeat(np.arange(vs, ve, dtype=np.int64), degs)
    dst = layout.csr_indices[e0:e1].astype(np.int64)
    w = layout.csr_w[e0:e1] if layout.csr_w is not None else None
    return src, dst, w


def _edited_partition(layout: Layout, p: int, delta: DeltaBuffer):
    """New (src, dst, w) arrays for dirty source partition ``p``,
    (src, dst)-sorted — old rows minus deleted/overwritten keys plus the
    partition's inserts."""
    q, n = layout.q, layout.n
    src, dst, w = _partition_edges(layout, p)
    ins_src, ins_dst, ins_w = delta.inserts()
    del_src, del_dst = delta.deletes()
    psel_i = (ins_src // q) == p if q else np.ones(len(ins_src), dtype=bool)
    psel_d = (del_src // q) == p if q else np.ones(len(del_src), dtype=bool)
    ins_src, ins_dst = ins_src[psel_i], ins_dst[psel_i]
    if ins_w is not None:
        ins_w = ins_w[psel_i]
    nk = max(n, 1)
    drop_keys = np.concatenate([ins_src * nk + ins_dst,
                                (del_src[psel_d] * nk + del_dst[psel_d])])
    keep = ~np.isin(src * nk + dst, drop_keys)
    src, dst = src[keep], dst[keep]
    if w is not None:
        w = w[keep]
    new_src = np.concatenate([src, ins_src])
    new_dst = np.concatenate([dst, ins_dst])
    new_w = None
    if layout.weighted:
        if len(ins_src) and ins_w is None:
            raise ValueError("weighted layout: insert() needs weights")
        ins_w = ins_w if ins_w is not None else np.zeros(0, dtype=np.float32)
        new_w = np.concatenate([w, ins_w]).astype(np.float32)
    order = np.lexsort((new_dst, new_src))
    new_src, new_dst = new_src[order], new_dst[order]
    if new_w is not None:
        new_w = new_w[order]
    return new_src, new_dst, new_w


def _clean_block_runs(k: int, dirty: list):
    """Maximal runs ``[g0, g1)`` of consecutive CLEAN gather-block keys
    (``g = dp*k + sp``; a block is dirty iff its source partition
    ``g % k`` is).  Old and new bin offsets stay in lockstep inside a
    run — no dirty block intervenes to change a padded size — so each
    run is one contiguous slice copy."""
    is_dirty = np.zeros(k * k, dtype=bool)
    if dirty:
        d = np.asarray(dirty, dtype=np.int64)
        is_dirty[(np.arange(k, dtype=np.int64)[:, None] * k + d).ravel()] \
            = True
    bnd = np.flatnonzero(np.diff(is_dirty.astype(np.int8))) + 1
    bounds = np.concatenate([[0], bnd, [k * k]])
    return [(int(g0), int(g1))
            for g0, g1 in zip(bounds[:-1], bounds[1:])
            if not is_dirty[g0]]


def apply_delta(layout: Layout, delta: DeltaBuffer) -> Layout:
    """Relayout only the partitions the delta dirties.

    Clean source partitions contribute their CSR rows, their PNG slot row
    (one contiguous copy — slot content is position-independent global
    ids) and their gather-side bin columns (whole padded blocks moved by a
    vectorized index map; ``msg_slot`` values shifted by the per-block PNG
    offset delta) byte-for-byte.  Dirty source partitions re-run the
    ``build_layout`` slot/rank algorithm restricted to their own edges.
    The result is bit-exact equal to a full ``build_layout`` of the edited
    graph with the same ``k`` and tile geometry.
    """
    if delta.k != layout.k or delta.q != layout.q or delta.n != layout.n:
        raise ValueError("delta was buffered against a different partitioning")
    t0 = time.perf_counter()
    k, q, n = layout.k, layout.q, layout.n
    n_pad = layout.n_pad
    msg_tile, edge_tile = layout.msg_tile, layout.edge_tile
    weighted = layout.weighted

    dirty = [int(p) for p in delta.src_partitions()]
    dirty_set = set(dirty)
    clean = [p for p in range(k) if p not in dirty_set]

    # ---- dirty partitions' new edge lists (clean ones stay sliced) ----
    part_rows = {p: _edited_partition(layout, p, delta) for p in dirty}

    # ---- CSR: dirty rows recomputed, clean rows sliced verbatim ----
    degs = np.zeros(n, dtype=np.int64)
    degs[:] = np.diff(layout.csr_indptr[:n + 1])
    seg_ind, seg_w = [], []
    for p in range(k):
        vs, ve = min(p * q, n), min((p + 1) * q, n)
        if p in dirty_set:
            src_p, dst_p, w_p = part_rows[p]
            if ve > vs:
                degs[vs:ve] = np.bincount(src_p - vs, minlength=ve - vs)
            seg_ind.append(dst_p)
            if weighted:
                seg_w.append(w_p)
        else:
            e0, e1 = int(layout.csr_indptr[vs]), int(layout.csr_indptr[ve])
            seg_ind.append(layout.csr_indices[e0:e1])
            if weighted:
                seg_w.append(layout.csr_w[e0:e1])
    m_new = sum(len(s) for s in seg_ind)
    csr_indices = np.concatenate(
        seg_ind or [np.zeros(0, dtype=np.int64)]).astype(np.int32)
    csr_w = None
    if weighted:
        csr_w = np.concatenate(
            seg_w or [np.zeros(0, dtype=np.float32)]).astype(np.float32)
    csr_indptr = np.zeros(n_pad + 2, dtype=np.int64)
    csr_indptr[1:n + 1] = np.cumsum(degs)
    csr_indptr[n + 1:] = m_new

    # ---- scatter side (PNG): per-source-partition slot rows ----
    old_blk_msg_pad = np.diff(layout.png_off)
    blk_msg_pad = old_blk_msg_pad.copy()
    # per-dirty-partition slot structure, in (dp, src, dst) edge order
    dirty_scatter = {}      # p -> dict of per-partition arrays
    for p in dirty:
        src_p, dst_p, w_p = part_rows[p]
        mp = len(src_p)
        dp = dst_p // q if q else np.zeros(mp, dtype=np.int64)
        order = np.argsort(dp, kind="stable")       # -> (dp, src, dst)
        src_s, dst_s, dp_s = src_p[order], dst_p[order], dp[order]
        w_s = w_p[order] if w_p is not None else None
        new_slot = np.ones(mp, dtype=bool)
        if mp > 1:
            same = (src_s[1:] == src_s[:-1]) & (dp_s[1:] == dp_s[:-1])
            new_slot[1:] = ~same
        slot_of_edge = np.cumsum(new_slot) - 1
        slot_src = src_s[new_slot]
        slot_dp = dp_s[new_slot]
        msg_cnt = np.bincount(slot_dp, minlength=k)
        blk_msg_pad[p * k:(p + 1) * k] = _pad_to_array(msg_cnt, msg_tile)
        dirty_scatter[p] = dict(
            src=src_s, dst=dst_s, dp=dp_s, w=w_s,
            slot_of_edge=slot_of_edge, slot_src=slot_src,
            slot_dp=slot_dp, msg_cnt=msg_cnt,
        )
    png_off = np.concatenate([[0], np.cumsum(blk_msg_pad)])
    nm_pad = int(png_off[-1])

    png_src = np.full(nm_pad, n_pad, dtype=np.int32)
    png_src_local = np.zeros(nm_pad, dtype=np.int32)
    for p in clean:
        o0, o1 = int(layout.png_off[p * k]), int(layout.png_off[(p + 1) * k])
        n0 = int(png_off[p * k])
        png_src[n0:n0 + (o1 - o0)] = layout.png_src[o0:o1]
        png_src_local[n0:n0 + (o1 - o0)] = layout.png_src_local[o0:o1]
    for p in dirty:
        ds = dirty_scatter[p]
        nslots = len(ds["slot_src"])
        starts = np.concatenate([[0], np.cumsum(ds["msg_cnt"])])[:-1]
        rank = (np.arange(nslots, dtype=np.int64)
                - np.repeat(starts, ds["msg_cnt"]))
        spos = png_off[p * k + ds["slot_dp"]] + rank
        ds["spos"] = spos
        png_src[spos] = ds["slot_src"]
        png_src_local[spos] = ds["slot_src"] - (ds["slot_src"] // q) * q
    if nm_pad:
        ntm = nm_pad // msg_tile
        tile_blk_m = np.searchsorted(png_off[1:], np.arange(ntm) * msg_tile,
                                     side="right")
        png_tile_part = (tile_blk_m // k).astype(np.int32)
    else:
        png_tile_part = np.zeros(0, dtype=np.int32)

    # ---- gather side (dc_bin): block key g = dp*k + sp ----
    old_blk_edge_pad = np.diff(layout.blk_off)
    blk_edge_pad = old_blk_edge_pad.copy()
    for p in dirty:
        cnt = np.bincount(dirty_scatter[p]["dp"], minlength=k)
        blk_edge_pad[np.arange(k) * k + p] = _pad_to_array(cnt, edge_tile)
        dirty_scatter[p]["edge_cnt"] = cnt
    blk_off = np.concatenate([[0], np.cumsum(blk_edge_pad)])
    ne_pad = int(blk_off[-1])

    msg_slot = np.full(ne_pad, nm_pad, dtype=np.int32)
    edge_dst = np.full(ne_pad, n_pad, dtype=np.int32)
    edge_src_local = np.zeros(ne_pad, dtype=np.int32)
    edge_dst_local = np.zeros(ne_pad, dtype=np.int32)
    edge_valid = np.zeros(ne_pad, dtype=bool)
    edge_w = np.zeros(ne_pad, dtype=np.float32) if weighted else None

    # clean gather blocks: whole padded blocks move in contiguous runs
    # (one memcpy per run — no dirty block inside a run, so old and new
    # offsets differ by a constant).  Content is position-independent
    # except msg_slot, which shifts by its PNG block's offset delta (and
    # pad slots re-point at the new global sentinel)
    old_nm_pad = int(layout.png_off[-1])
    gk_all = np.arange(k * k, dtype=np.int64)
    sblk_all = (gk_all % k) * k + (gk_all // k)
    blk_shift = (png_off[sblk_all]
                 - layout.png_off[sblk_all]).astype(np.int32)
    for g0, g1 in _clean_block_runs(k, dirty):
        o0, o1 = int(layout.blk_off[g0]), int(layout.blk_off[g1])
        if o1 == o0:
            continue
        sl = slice(int(blk_off[g0]), int(blk_off[g0]) + (o1 - o0))
        valid = layout.edge_valid[o0:o1]
        edge_dst[sl] = layout.edge_dst[o0:o1]
        edge_src_local[sl] = layout.edge_src_local[o0:o1]
        edge_dst_local[sl] = layout.edge_dst_local[o0:o1]
        edge_valid[sl] = valid
        if weighted:
            edge_w[sl] = layout.edge_w[o0:o1]
        shift = blk_shift[g0:g1]
        if not shift.any() and nm_pad == old_nm_pad:
            msg_slot[sl] = layout.msg_slot[o0:o1]
        else:
            # pads in the destination already hold the new sentinel
            # (the np.full init): shift only the valid slots, in place
            shift_e = np.repeat(shift, old_blk_edge_pad[g0:g1])
            np.add(layout.msg_slot[o0:o1], shift_e, out=msg_slot[sl],
                   where=valid)
    for p in dirty:
        ds = dirty_scatter[p]
        mp = len(ds["src"])
        if mp == 0:
            continue
        starts = np.concatenate([[0], np.cumsum(ds["edge_cnt"])])[:-1]
        rank = (np.arange(mp, dtype=np.int64)
                - np.repeat(starts, ds["edge_cnt"]))
        epos = blk_off[ds["dp"] * k + p] + rank
        edge_dst[epos] = ds["dst"]
        edge_src_local[epos] = ds["src"] - (ds["src"] // q) * q
        edge_dst_local[epos] = ds["dst"] - ds["dp"] * q
        edge_valid[epos] = True
        if weighted:
            edge_w[epos] = ds["w"]
        msg_slot[epos] = ds["spos"][ds["slot_of_edge"]]

    # ---- per-tile metadata + per-partition constants (cheap, global) ----
    nt = ne_pad // edge_tile
    tile_blk = np.searchsorted(blk_off[1:], np.arange(nt) * edge_tile,
                               side="right")
    tile_dst_part = (tile_blk // k).astype(np.int32)
    tile_src_part = (tile_blk % k).astype(np.int32)
    tile_first = np.ones(nt, dtype=bool)
    tile_first[1:] = tile_dst_part[1:] != tile_dst_part[:-1]
    part_has_tiles = np.zeros(k, dtype=bool)
    part_has_tiles[tile_dst_part] = True

    part_edges = layout.part_edges.copy()
    part_msgs = layout.part_msgs.copy()
    for p in dirty:
        part_edges[p] = len(dirty_scatter[p]["src"])
        part_msgs[p] = len(dirty_scatter[p]["slot_src"])
    deg = np.zeros(n_pad, dtype=np.int64)
    deg[:n] = degs

    new = Layout(
        k=k, q=q, n=n, m=m_new, weighted=weighted,
        png_src=png_src, png_src_local=png_src_local, png_off=png_off,
        png_tile_part=png_tile_part,
        msg_slot=msg_slot, edge_dst=edge_dst,
        edge_src_local=edge_src_local, edge_dst_local=edge_dst_local,
        edge_valid=edge_valid, edge_w=edge_w, blk_off=blk_off,
        edge_tile=edge_tile, msg_tile=msg_tile,
        fold_tile=layout.fold_tile, fold_q=layout.fold_q,
        tile_src_part=tile_src_part, tile_dst_part=tile_dst_part,
        tile_first=tile_first, part_has_tiles=part_has_tiles,
        csr_indptr=csr_indptr, csr_indices=csr_indices, csr_w=csr_w,
        part_edges=part_edges, part_msgs=part_msgs, deg=deg,
    )
    if obs.enabled():
        obs.event("delta_apply", dirty_parts=len(dirty), k=k,
                  inserts=delta.num_inserts, deletes=delta.num_deletes,
                  wall_s=time.perf_counter() - t0)
    return new

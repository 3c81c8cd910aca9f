"""Device-sharded partition-centric layout.

Level-1 partitioning: ``k`` partitions are distributed over ``D`` ranks
(``kpd = k/D`` partitions per rank, index-contiguous, the rule the paper
uses for threads).  The 2D bin grid becomes a per-(source rank, destination
rank) exchange:

  * DC mode: the scatter-side message buffer is ``out[D, S]`` (slot tiles
    grouped by destination rank, values only); one dense all-to-all delivers
    every bin column to its owner, after which the statically resident
    ``in_msg_slot`` / ``in_dst_local`` arrays (the paper's pre-written
    ``dc_bin``) drive a local segmented fold.
  * SC mode: out-edges grouped by destination rank with per-group compaction
    and a ragged exchange, wire bytes proportional to the active edges.

Every per-rank array is padded to the largest rank's size (each rank runs
the same shapes); the real sizes stay in the cost-model fields.

A NumPy copy of :mod:`repro.graph.shard`: the same arrays, field for field.
:func:`sharded_spec` describes its arrays with tensors on PyTorch's ``meta``
device in place of the reference's ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .layout import Layout, _pad_to


@dataclasses.dataclass
class ShardedLayout:
    D: int
    kpd: int                 # partitions per rank
    q: int
    nv: int                  # vertices per rank = kpd * q
    n: int                   # real vertex count (global)
    S: int                   # message-slot capacity per (src, dst) rank pair
    weighted: bool
    fold_tile: int           # blocked-fold message tile (from the Layout)
    fold_q: int              # two-level fold bucket width (from the Layout)

    # ---- DC scatter side (per source rank) ----
    out_src_local: np.ndarray   # int32[D, D, S]
    out_valid: np.ndarray       # bool [D, D, S]

    # ---- DC gather side (per destination rank) ----
    in_msg_slot: np.ndarray     # int32[D, NEd] -> index into recv[D*S] (sentinel D*S)
    in_dst_local: np.ndarray    # int32[D, NEd] (sentinel nv)
    in_valid: np.ndarray        # bool [D, NEd]
    in_w: Optional[np.ndarray]  # f32  [D, NEd]

    # ---- SC side: out-edges grouped by destination rank ----
    oe_src_local: np.ndarray    # int32[D, NEs]
    oe_dst_local: np.ndarray    # int32[D, NEs] (local to the *destination*)
    oe_valid: np.ndarray        # bool [D, NEs]
    oe_w: Optional[np.ndarray]  # f32  [D, NEs]
    oe_group_off: np.ndarray    # int64[D, D+1] group boundaries
    cap_in: int                 # SC receive capacity (max in-edges/rank)
    cap_pair: int               # SC per-(src,dst)-pair capacity

    # host-side cost-model stats
    part_edges: np.ndarray      # int64[k] (global, from Layout)
    part_msgs: np.ndarray
    deg: np.ndarray             # int64[D*nv] sharded-order out-degrees

    @property
    def ne_d(self) -> int:
        return self.in_msg_slot.shape[1]

    @property
    def ne_s(self) -> int:
        return self.oe_src_local.shape[1]

    def arrays(self) -> dict:
        """The rank-partitioned arrays the step functions read (leading
        axis: the rank)."""
        d = dict(out_src_local=self.out_src_local, out_valid=self.out_valid,
                 in_msg_slot=self.in_msg_slot, in_dst_local=self.in_dst_local,
                 in_valid=self.in_valid,
                 oe_src_local=self.oe_src_local, oe_dst_local=self.oe_dst_local,
                 oe_valid=self.oe_valid, oe_group_off=self.oe_group_off)
        if self.weighted:
            d["in_w"] = self.in_w
            d["oe_w"] = self.oe_w
        return d


def shard_layout(L: Layout, D: int) -> ShardedLayout:
    """Regroup a single-device Layout for D ranks (k must divide by D)."""
    k, q = L.k, L.q
    if k % D:
        raise ValueError(f"k={k} not divisible by D={D}")
    kpd = k // D
    nv = kpd * q
    n_pad = L.n_pad
    nm_pad = L.num_msgs

    # ---------- DC scatter side: regroup PNG slots by rank pair ----------
    slot_blk = np.repeat(np.arange(k * k, dtype=np.int64),
                         np.diff(L.png_off))
    sp_, dp_ = slot_blk // k, slot_blk % k
    sdev, ddev = sp_ // kpd, dp_ // kpd
    pair = sdev * D + ddev
    order = np.argsort(pair, kind="stable")
    pair_cnt = np.bincount(pair, minlength=D * D)
    S = _pad_to(int(pair_cnt.max(initial=0)), 8)
    rank = np.arange(nm_pad) - np.repeat(
        np.concatenate([[0], np.cumsum(pair_cnt)])[:-1], pair_cnt)
    pos = np.empty(nm_pad, dtype=np.int64)
    pos[order] = rank                                    # position within pair
    # out buffers
    out_src_local = np.zeros((D, D, S), dtype=np.int32)
    out_valid = np.zeros((D, D, S), dtype=bool)
    real = L.png_src < n_pad
    out_src_local[sdev[real], ddev[real], pos[real]] = \
        (L.png_src[real] - sdev[real].astype(np.int64) * nv).astype(np.int32)
    out_valid[sdev[real], ddev[real], pos[real]] = True
    # receive-side index of each slot: row = source rank, col = pos
    slot_recv = (sdev * S + pos).astype(np.int64)        # in [0, D*S)

    # ---------- DC gather side: per-destination-rank edge slices ----------
    # gather-order blocks are keyed p'*k + p, so each rank's incoming edges
    # are one contiguous range of the global arrays.
    dev_edge_lo = L.blk_off[np.arange(D) * kpd * k]
    dev_edge_hi = L.blk_off[(np.arange(D) + 1) * kpd * k]
    ne_d = _pad_to(int((dev_edge_hi - dev_edge_lo).max(initial=0)),
                   L.edge_tile)
    in_msg_slot = np.full((D, ne_d), D * S, dtype=np.int32)
    in_dst_local = np.full((D, ne_d), nv, dtype=np.int32)
    in_valid = np.zeros((D, ne_d), dtype=bool)
    in_w = np.zeros((D, ne_d), dtype=np.float32) if L.weighted else None
    for d in range(D):
        lo, hi = int(dev_edge_lo[d]), int(dev_edge_hi[d])
        c = hi - lo
        ms = L.msg_slot[lo:hi]
        ok = ms < nm_pad
        slot_mapped = np.full(c, D * S, dtype=np.int32)
        slot_mapped[ok] = slot_recv[ms[ok]].astype(np.int32)
        in_msg_slot[d, :c] = slot_mapped
        dst = L.edge_dst[lo:hi].astype(np.int64)
        dok = dst < n_pad
        dl = np.full(c, nv, dtype=np.int32)
        dl[dok] = (dst[dok] - d * nv).astype(np.int32)
        in_dst_local[d, :c] = dl
        in_valid[d, :c] = L.edge_valid[lo:hi]
        if L.weighted:
            in_w[d, :c] = L.edge_w[lo:hi]

    # ---------- SC side: out-edges grouped by (src rank, dst rank) ------
    deg_np = L.deg
    src_g = np.repeat(np.arange(L.n, dtype=np.int64),
                      deg_np[:L.n].astype(np.int64))
    dst_g = L.csr_indices.astype(np.int64)
    w_g = L.csr_w
    sdev_e = src_g // nv
    ddev_e = dst_g // nv
    okey = sdev_e * D + ddev_e
    eorder = np.argsort(okey, kind="stable")
    src_g, dst_g, okey = src_g[eorder], dst_g[eorder], okey[eorder]
    sdev_e, ddev_e = sdev_e[eorder], ddev_e[eorder]
    if w_g is not None:
        w_g = w_g[eorder]
    per_dev_cnt = np.bincount(sdev_e, minlength=D)
    ne_s = _pad_to(int(per_dev_cnt.max(initial=0)), 8)
    oe_src_local = np.zeros((D, ne_s), dtype=np.int32)
    oe_dst_local = np.zeros((D, ne_s), dtype=np.int32)
    oe_valid = np.zeros((D, ne_s), dtype=bool)
    oe_w = np.zeros((D, ne_s), dtype=np.float32) if L.weighted else None
    oe_group_off = np.zeros((D, D + 1), dtype=np.int64)
    dev_starts = np.concatenate([[0], np.cumsum(per_dev_cnt)])
    grp_cnt = np.bincount(okey, minlength=D * D).reshape(D, D)
    for d in range(D):
        lo, hi = int(dev_starts[d]), int(dev_starts[d + 1])
        c = hi - lo
        oe_src_local[d, :c] = (src_g[lo:hi] - d * nv).astype(np.int32)
        oe_dst_local[d, :c] = (dst_g[lo:hi]
                               - ddev_e[lo:hi] * nv).astype(np.int32)
        oe_valid[d, :c] = True
        if w_g is not None:
            oe_w[d, :c] = w_g[lo:hi]
        oe_group_off[d, 1:] = np.cumsum(grp_cnt[d])
    in_cnt = np.bincount(np.minimum(dst_g // nv, D - 1), minlength=D)
    cap_in = _pad_to(int(in_cnt.max(initial=1)), 8)
    cap_pair = _pad_to(int(grp_cnt.max(initial=1)), 8)

    deg_pad = np.zeros(D * nv, dtype=np.int64)
    deg_pad[:n_pad] = deg_np
    return ShardedLayout(
        D=D, kpd=kpd, q=q, nv=nv, n=L.n, S=S, weighted=L.weighted,
        fold_tile=L.fold_tile, fold_q=L.fold_q,
        out_src_local=out_src_local, out_valid=out_valid,
        in_msg_slot=in_msg_slot, in_dst_local=in_dst_local,
        in_valid=in_valid, in_w=in_w,
        oe_src_local=oe_src_local, oe_dst_local=oe_dst_local,
        oe_valid=oe_valid, oe_w=oe_w, oe_group_off=oe_group_off,
        cap_in=cap_in, cap_pair=cap_pair,
        part_edges=L.part_edges, part_msgs=L.part_msgs, deg=deg_pad)


def sharded_spec(n: int, m: int, D: int, k_per_dev: int = 4,
                 weighted: bool = False, slot_slack: float = 1.3,
                 edge_slack: float = 1.3):
    """Shape-only ShardedLayout stand-in: ``(arrays, meta)``, the arrays as
    tensors on the ``meta`` device (shape and dtype, no storage).

    Buffer sizes follow the same formulas as :func:`shard_layout` but from
    expectations: slots/pair ~ m/D^2 (power-law graphs at rank granularity
    are near-uniform under index hashing), edges/rank ~ m/D.
    """
    import torch

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    k = D * k_per_dev
    q = _pad_to(-(-n // k), 128)
    nv = k_per_dev * q
    S = _pad_to(int(m / (D * D) * slot_slack) + 8, 8)
    ne_d = _pad_to(int(m / D * edge_slack) + 8, 256)
    ne_s = _pad_to(int(m / D * edge_slack) + 8, 8)
    arrs = dict(
        out_src_local=spec((D, D, S), torch.int32),
        out_valid=spec((D, D, S), torch.bool),
        in_msg_slot=spec((D, ne_d), torch.int32),
        in_dst_local=spec((D, ne_d), torch.int32),
        in_valid=spec((D, ne_d), torch.bool),
        oe_src_local=spec((D, ne_s), torch.int32),
        oe_dst_local=spec((D, ne_s), torch.int32),
        oe_valid=spec((D, ne_s), torch.bool),
        oe_group_off=spec((D, D + 1), torch.int64),
    )
    if weighted:
        arrs["in_w"] = spec((D, ne_d), torch.float32)
        arrs["oe_w"] = spec((D, ne_s), torch.float32)
    cap_pair = _pad_to(int(m / (D * D) * edge_slack) + 8, 8)
    meta = dict(D=D, kpd=k_per_dev, q=q, nv=nv, S=S, cap_in=ne_s,
                cap_pair=cap_pair, weighted=weighted)
    return arrs, meta

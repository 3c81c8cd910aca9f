"""Distributed PPM engine: one process per rank, bins exchanged with
``torch.distributed`` all-to-alls.

Counterpart of :mod:`repro.dist.engine` over a
:class:`repro_torch.graph.shard.ShardedLayout`.  The BSP structure of the
paper maps onto collectives one to one:

  Scatter (per rank, local)   -> message buffer out[D, S] (DC) or
                                 per-destination compaction (SC)
  barrier + bin exchange      -> ``all_to_all_single`` (equal splits for the
                                 DC bins and the dense SC form; split sizes
                                 for the ragged SC form)
  Gather (per rank, local)    -> the segmented fold over the statically
                                 resident dc_bin adjacency: the layout-free
                                 fused kernel (``csrc/fused_stream.cu``,
                                 partitioned regime: a destination
                                 partition a block) on the received bin
                                 table, or under ``REPRO_FUSED=0`` the slot
                                 gather and the segment fold
                                 (``csrc/segment_fold.cu``)

DC mode sends values only (+ the validity flags, a packed bitmap by
default); SC mode sends ``(value, dst)`` pairs, priced by the active edges.
``mode='hybrid'`` applies the aggregated Eq. 1 model per iteration,
``mode='hybrid_pp'`` applies it per partition and runs both streams in one
superstep.

Where the reference runs one controller over a device mesh, each rank here
runs the same host loop on its own shard (SPMD), and every decision the loop
takes comes from collectives, so that the ranks never diverge: the active
counts are summed over the ranks (in int64, which never wraps), Eq. 1 runs
on the same host arrays everywhere, and each rank takes its slice of the
per-partition DC mask.  :meth:`DistEngine.run` and
:meth:`DistEngine.run_batched` take the global ``[D*nv]`` (or ``[B, D*nv]``)
state and frontier on every rank, as the reference's do, and return global
tensors: each rank slices out its shard, and the result is all-gathered at
the end.  ``D*nv == n_pad``, so the apps build their state unchanged.

``uint32`` data (BFS and CC state) crosses the wire through ``int32`` views
and flags through ``uint8`` ones (gloo refuses ``uint32``); the bf16 wire
packs two messages into one 32-bit lane, as the reference does.  Telemetry
(``engine_iter`` events and the rest) is recorded on rank 0 only, so a run's
events equal the reference's single-controller ones.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..core import monoid as M
from ..core.cost import CostModel
from ..core.engine import _run_batched_loop, _tree_where, resolve_device
from ..core.program import VertexProgram
from ..kernels.fused_step import fused_enabled, part_ranges
from ..kernels.ops import FoldKernel, FusedStreamKernel

MODES = ("dc", "sc", "hybrid", "hybrid_pp")


# ----------------------------------------------------------------------
# wire compression: what actually crosses the all-to-all
# ----------------------------------------------------------------------

def _pack_bf16_pairs(vals, ident):
    """``[..., S]`` bf16 -> ``[..., ceil(S/2)]`` int32 wire lanes, two bf16
    messages a lane (the first in the low half: the reference's ``uint32``
    lanes, bit for bit).  Odd ``S`` is padded with one identity column
    first (dropped by :func:`_unpack_bf16_pairs`)."""
    S = vals.shape[-1]
    if S % 2:
        pad = torch.full(vals.shape[:-1] + (1,), ident, dtype=vals.dtype,
                         device=vals.device)
        vals = torch.cat([vals, pad], -1)
    return vals.contiguous().view(torch.int32)


def _unpack_bf16_pairs(packed, S):
    """Inverse of :func:`_pack_bf16_pairs`: ``[..., P]`` int32 -> ``[...,
    S]`` bf16 (the odd-S identity pad column is discarded)."""
    return packed.contiguous().view(torch.bfloat16)[..., :S]


def _pack_bits(flags):
    """``[..., S]`` bool -> ``[..., ceil(S/8)]`` uint8 frontier bitmap,
    flag ``j`` of a byte in bit ``j``: 8x smaller than bool lanes."""
    S = flags.shape[-1]
    Sp = -(-S // 8) * 8
    if Sp != S:
        pad = torch.zeros(flags.shape[:-1] + (Sp - S,), dtype=torch.bool,
                          device=flags.device)
        flags = torch.cat([flags, pad], -1)
    bits = flags.reshape(flags.shape[:-1] + (Sp // 8, 8)).to(torch.uint8)
    weights = torch.tensor([1 << j for j in range(8)], dtype=torch.uint8,
                           device=flags.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)


def _unpack_bits(packed, S):
    """Inverse of :func:`_pack_bits`: ``[..., P]`` uint8 -> ``[..., S]``
    bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :S] != 0


def dc_wire_bytes(meta: dict, value_itemsize: int, *,
                  compressed: bool = False, wire_bitmap: bool = True,
                  dense_frontier: bool = False, batch: int = 1) -> int:
    """Per-step, per-rank all-to-all payload bytes of the DC bin exchange
    (values + validity flags), for cost reporting.

    ``compressed`` means the bf16 wire is actually active (``wire_bf16``
    requested AND the monoid is f32); ``batch`` scales both payloads by the
    live lane width of a batched step."""
    S, D = meta["S"], meta["D"]
    if compressed:
        val = D * (S + (S % 2)) * 2          # 32-bit lanes, 2 bf16 each
    else:
        val = D * S * value_itemsize
    if dense_frontier:
        flags = 0
    else:
        flags = D * (-(-S // 8) if wire_bitmap else S)
    return batch * (val + flags)


# ----------------------------------------------------------------------
# collectives and gathers on any 4- or 8-byte type
# ----------------------------------------------------------------------

def _all_to_all(x, mesh, out_splits=None, in_splits=None):
    """Row blocks of ``x`` (dim 0) to the ranks: equal ``[D, ...]`` blocks,
    or ``in_splits`` rows to each rank and ``out_splits`` rows from each.
    ``uint32`` and ``bool`` move through same-width views."""
    if x.dtype in (torch.uint32, torch.bool):
        carrier = torch.int32 if x.dtype == torch.uint32 else torch.uint8
        return _all_to_all(x.view(carrier), mesh, out_splits,
                           in_splits).view(x.dtype)
    x = x.contiguous()
    rows = x.shape[0] if out_splits is None else sum(out_splits)
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_to_all_single(out, x, out_splits, in_splits, group=mesh.group)
    return out


def _exchange(x, mesh, dev_ax: int):
    """The bin exchange over the rank axis ``dev_ax`` of ``x``: 0, or 1
    behind a lane axis (``[B, D, S]`` moves as a contiguous ``[D, B, S]``:
    ``all_to_all_single`` splits dim 0)."""
    if dev_ax == 0:
        return _all_to_all(x, mesh)
    return _all_to_all(x.transpose(0, 1), mesh).transpose(0, 1)


def _take(x, idx):
    """``x[..., idx]`` for any dtype, ``uint32`` included."""
    flat = M.as_bits(x).index_select(-1, idx.reshape(-1))
    return M.from_bits(flat.reshape(x.shape[:-1] + idx.shape), x.dtype)


def _fold_lanes(fold, vals, valid, ids, ns):
    """Per-lane segmented fold of ``[B, N]`` streams: B folds, each as the
    sequential fold (the reference's unroll)."""
    accs, touch = [], []
    for i in range(vals.shape[0]):
        a, t = fold(vals[i], valid[i], ids[i], ns)
        accs.append(a)
        touch.append(t)
    return torch.stack(accs), torch.stack(touch)


def _resolve_fold(program: VertexProgram, plain: bool = False):
    """The rank-local segmented fold (``csrc/segment_fold.cu`` on a card)."""
    return FoldKernel(program.monoid.name, plain=plain)


def _resolve_fused(program: VertexProgram, plain: bool = False):
    """The rank-local fused gather→fold on the received bin table
    (``csrc/fused_stream.cu`` on a card), or None under ``REPRO_FUSED=0``:
    then the DC gather stays on the composed slot gather + fold, as in the
    reference.  The kernel folds every (monoid, dtype) the apps use, so
    there is no per-monoid fallback."""
    if not fused_enabled():
        return None
    return FusedStreamKernel(program.monoid.name, program.monoid.dtype,
                             plain=plain)


def _edge_fn(program: VertexProgram, meta: dict):
    """The program's edge function where the graph is weighted."""
    return program.apply_weight if meta["weighted"] else None


def _init_frontier(program, state, active, it):
    """initFrontier: ``(state, keep)``."""
    if program.init_fn is None:
        return state, torch.zeros_like(active)
    st2, keep = program.init_fn(state, it)
    return _tree_where(active, st2, state), keep & active


def _apply(program, state, acc, touched, keep, it):
    """Gather apply and filterFrontier: ``(state, new_active)``."""
    st3, activated = program.apply_fn(state, acc, touched, it)
    state = _tree_where(touched, st3, state)
    new_active = keep | (activated & touched)
    if program.filter_fn is not None:
        st4, fkeep = program.filter_fn(state, it)
        state = _tree_where(new_active, st4, state)
        new_active = new_active & fkeep
    return state, new_active


def _bin_table(out_vals, flag, ident, mesh, dev_ax, compress=False,
               wire_bitmap=False, dense_frontier=False):
    """The bin exchange: ``[.., D, S]`` values and flags out, the received
    table ``rv`` and its validity ``rf`` ``[.., D*S + 1]`` back (the last
    slot the identity, never valid: the sentinel of ``in_msg_slot``)."""
    D, S = out_vals.shape[-2:]
    lead = tuple(out_vals.shape[:-2])
    dev = out_vals.device
    if compress:
        recv_vals = _unpack_bf16_pairs(
            _exchange(_pack_bf16_pairs(out_vals, ident), mesh, dev_ax), S)
    else:
        recv_vals = _exchange(out_vals, mesh, dev_ax)
    if dense_frontier:
        # validity is static (= out_valid of the sender); the receive side's
        # static in_valid already encodes it
        rf = torch.ones(lead + (D * S + 1,), dtype=torch.bool, device=dev)
        rf[..., -1] = False
    else:
        if wire_bitmap:
            recv_flag = _unpack_bits(
                _exchange(_pack_bits(flag), mesh, dev_ax), S)
        else:
            recv_flag = _exchange(flag, mesh, dev_ax)
        rf = torch.cat([recv_flag.reshape(lead + (D * S,)),
                        torch.zeros(lead + (1,), dtype=torch.bool,
                                    device=dev)], -1)
    rv = M.from_bits(torch.cat(
        [M.as_bits(recv_vals.reshape(lead + (D * S,))),
         M.as_bits(M.full(lead + (1,), ident, recv_vals.dtype, dev))], -1),
        recv_vals.dtype)
    return rv, rf


def _gather_bins(program, meta, rv, rf, A, fold, fused, batched):
    """The gather over the pre-written dc_bin: ``(acc, touched)`` over the
    rank's ``[.., nv]`` vertices.  Fused: the kernel gathers each edge's
    value from the received table itself (one launch a lane, each over the
    rank's destination-partition ranges ``A["in_parts"]``), the table
    cast off the wire type first (the cast commutes with the gather, so the
    composed path's ``rv[slot].to`` gives the same bits).  Composed: the
    slot gather into an ``[.., NEd]`` edge stream, then the fold."""
    mono, nv = program.monoid, meta["nv"]
    aw = _edge_fn(program, meta)
    slot, evalid_s, dst_s = A["in_msg_slot"], A["in_valid"], A["in_dst_local"]
    if fused is not None:
        table = rv.to(mono.dtype)
        w = A["in_w"] if aw is not None else None
        parts = A["in_parts"]
        if batched:
            # one launch a lane: the static slot/validity/dst streams are
            # shared
            lanes = [fused(table[i], rf[i], slot, evalid_s, dst_s, nv + 1,
                           w=w, apply_weight=aw, parts=parts)
                     for i in range(table.shape[0])]
            acc = torch.stack([a for a, _ in lanes])
            touched = torch.stack([t for _, t in lanes])
        else:
            acc, touched = fused(table, rf, slot, evalid_s, dst_s, nv + 1,
                                 w=w, apply_weight=aw, parts=parts)
    else:
        ev = _take(rv, slot).to(mono.dtype)                   # [.., NEd]
        evalid = _take(rf, slot) & evalid_s
        if aw is not None:
            ev = aw(ev, A["in_w"]).to(mono.dtype)
        ev = M.where(evalid, ev, M.full((), mono.identity, mono.dtype,
                                       ev.device))
        dst = torch.where(evalid, dst_s, nv)
        if batched:
            acc, touched = _fold_lanes(fold, ev, evalid, dst, nv + 1)
        else:
            acc, touched = fold(ev, evalid, dst, nv + 1)
    return acc[..., :nv], touched[..., :nv]


def _sc_groups(oe_group_off, ne_s: int, D: int):
    """Each out-edge slot's destination-rank group (the last group for the
    padding past ``oe_group_off[D]``): static, computed once per engine."""
    slots = torch.arange(ne_s, device=oe_group_off.device)
    grp = torch.searchsorted(oe_group_off[1:], slots, right=True)
    return grp.clamp_(max=D - 1)


def _sc_stream(program, meta, mesh, msgs, sc_active, A, ragged):
    """The SC exchange of ``sc_active``'s out-edges: the received ``(vals,
    valid, ids)`` message stream for the rank's fold into ``nv + 1``.

    The active out-edges of each destination-rank group are compacted by a
    running count.  Dense form (the engine's, the reference's portable
    emulation): per-pair rows of ``cap_pair`` slots over an equal-split
    all-to-all, with the pair counts exchanged beside them, so the receiver
    masks the rows' tails.  Ragged form: the counts cross first and come
    back to the host (one sync), then one all-to-all with split sizes moves
    exactly the active edges."""
    mono = program.monoid
    nv, D, cap_pair = meta["nv"], meta["D"], meta["cap_pair"]
    dev = msgs.device
    src, grp = A["oe_src_local"], A["oe_grp"]
    ne_s = src.shape[0]
    act_e = A["oe_valid"] & _take(sc_active, src)
    vals_e = _take(msgs, src)
    aw = _edge_fn(program, meta)
    if aw is not None:
        vals_e = aw(vals_e, A["oe_w"]).to(mono.dtype)
    c = torch.cumsum(act_e, 0)
    co = torch.cat([torch.zeros(1, dtype=c.dtype, device=dev), c])
    tot_at = co[A["oe_group_off"]]                          # [D+1]
    send_sizes = tot_at[1:] - tot_at[:-1]                   # [D]
    rank = (c - 1) - tot_at[grp]                            # rank in group
    recv_sizes = _all_to_all(send_sizes.reshape(D, 1), mesh).reshape(D)

    def compact(flat, n):
        """Active edges' values and destinations at ``flat`` of ``n``
        slots (inactive ones land in the scratch slot ``n``)."""
        vals = M.full((n + 1,), mono.identity, mono.dtype, dev)
        vals = M.from_bits(M.as_bits(vals).scatter_(0, flat,
                                                    M.as_bits(vals_e)),
                           mono.dtype)[:n]
        ids = torch.full((n + 1,), nv, dtype=torch.int32, device=dev)
        ids = ids.scatter_(0, flat, A["oe_dst_local"])[:n]
        return vals, ids

    if ragged:
        send_off = torch.cumsum(send_sizes, 0) - send_sizes
        vals, ids = compact(torch.where(act_e, send_off[grp] + rank, ne_s),
                            ne_s)
        sizes = torch.stack([send_sizes, recv_sizes]).cpu()
        send_l, recv_l = sizes[0].tolist(), sizes[1].tolist()
        total = sum(send_l)
        rvals = _all_to_all(vals[:total], mesh, recv_l, send_l)
        rids = _all_to_all(ids[:total], mesh, recv_l, send_l)
        valid = torch.ones(rids.shape[0], dtype=torch.bool, device=dev)
        return rvals, valid, rids
    vals, ids = compact(torch.where(act_e, grp * cap_pair + rank,
                                    D * cap_pair), D * cap_pair)
    rvals = _all_to_all(vals.reshape(D, cap_pair), mesh).reshape(-1)
    rids = _all_to_all(ids.reshape(D, cap_pair), mesh).reshape(-1)
    col = torch.arange(cap_pair, device=dev)
    valid = (col[None, :] < recv_sizes[:, None]).reshape(-1)
    ids = torch.where(valid, rids, nv)
    vals = M.where(valid, rvals, M.full((), mono.identity, mono.dtype, dev))
    return vals, valid, ids


def _bins_out(program, msgs, active_src, A, wdt):
    """The scatter: the bin rows ``[.., D, S]`` (values in the wire type
    ``wdt``, the identity where a slot carries nothing) and their flags."""
    srcl = A["out_src_local"]
    flag = A["out_valid"] & _take(active_src, srcl)
    out_vals = M.where(flag, _take(msgs, srcl),
                       M.full((), program.monoid.identity, wdt, msgs.device))
    return out_vals, flag


def build_dc_step(program: VertexProgram, meta: dict, mesh,
                  dense_frontier: bool = False, wire_bf16: bool = False,
                  wire_bitmap: bool = False, fold=None, fused=None,
                  batched: bool = False):
    """Destination-centric distributed iteration (per-rank body):
    ``step(state, active, arrays, it) -> (state, active)`` on the rank's
    ``[nv]`` shard (``[B, nv]`` when ``batched``).

    dense_frontier: the app keeps every vertex active every iteration
    (paper's PageRank): the validity-flag exchange is constant and is
    skipped.  wire_bf16: cast f32 message values to bf16 on the wire
    (exact for the integer id monoids of BFS/CC, where it does not engage;
    approximate for float accumulations); odd ``S`` pads the packed lane.
    wire_bitmap: exchange the validity flags as a packed bitmap (8x smaller
    than bool lanes, bit-exact).  batched: a leading query-lane axis; the
    exchange moves ``[B, D, S]`` in one collective per payload and the
    gather folds lane by lane.  fused: a :class:`FusedStreamKernel`, or
    None for the composed slot gather + ``fold``."""
    mono = program.monoid
    compress = wire_bf16 and mono.dtype == torch.float32
    fold = fold if fold is not None else _resolve_fold(program)
    # the wire type lives from the scatter through the exchange
    wdt = torch.bfloat16 if compress else mono.dtype
    dev_ax = 1 if batched else 0

    def step(state, active, A, it):
        msgs = program.scatter_fn(state).to(wdt)
        state, keep = _init_frontier(program, state, active, it)
        out_vals, flag = _bins_out(program, msgs, active, A, wdt)
        rv, rf = _bin_table(out_vals, flag, mono.identity, mesh, dev_ax,
                            compress=compress, wire_bitmap=wire_bitmap,
                            dense_frontier=dense_frontier)
        acc, touched = _gather_bins(program, meta, rv, rf, A, fold, fused,
                                    batched)
        return _apply(program, state, acc, touched, keep, it)

    return step


def build_sc_step(program: VertexProgram, meta: dict, mesh,
                  ragged: bool = False, fold=None):
    """Source-centric distributed iteration: per-destination compaction and
    the exchange of :func:`_sc_stream` (dense per-pair rows, the engine's
    form, or ``ragged=True``: split sizes, one host sync a step).  The Eq. 1
    cost model prices the SC wire bytes as ragged either way."""
    fold = fold if fold is not None else _resolve_fold(program)
    nv = meta["nv"]

    def step(state, active, A, it):
        msgs = program.scatter_fn(state).to(program.monoid.dtype)
        state, keep = _init_frontier(program, state, active, it)
        vals, valid, ids = _sc_stream(program, meta, mesh, msgs, active, A,
                                      ragged)
        acc, touched = fold(vals, valid, ids, nv + 1)
        return _apply(program, state, acc[:nv], touched[:nv], keep, it)

    return step


def build_hybrid_step(program: VertexProgram, meta: dict, mesh, fold=None):
    """Per-partition dual-mode iteration, the paper's exact granularity
    (Eq. 1 decided per partition, not per iteration):
    ``step(state, active, arrays, it, dc_mask)``.

    ``dc_mask`` (one bool per local partition) selects, per partition,
    whether its vertices scatter through the DC bins or the compacted SC
    exchange; both streams fold into the same accumulator, as in the
    single-device engine.  As in the reference, the DC stream here takes
    the plain wire (no bf16, bool flags) and the composed gather."""
    mono = program.monoid
    nv, q = meta["nv"], meta["nv"] // meta["kpd"]
    fold = fold if fold is not None else _resolve_fold(program)

    def step(state, active, A, it, dc_mask):
        msgs = program.scatter_fn(state).to(mono.dtype)
        state, keep = _init_frontier(program, state, active, it)
        dc_v = dc_mask[torch.arange(nv, device=active.device) // q]
        # ---- DC stream: active vertices of DC-mode partitions ----
        out_vals, flag = _bins_out(program, msgs, active & dc_v, A,
                                   mono.dtype)
        rv, rf = _bin_table(out_vals, flag, mono.identity, mesh, 0)
        acc, touched = _gather_bins(program, meta, rv, rf, A, fold, None,
                                    False)
        # ---- SC stream: active vertices of the other partitions ----
        vals, valid, ids = _sc_stream(program, meta, mesh, msgs,
                                      active & ~dc_v, A, False)
        acc2, touched2 = fold(vals, valid, ids, nv + 1)
        acc = mono.combine(acc, acc2[:nv])
        touched = touched | touched2[:nv]
        return _apply(program, state, acc, touched, keep, it)

    return step


class DistEngine:
    """Multi-device PPM engine: this rank's part of it.

    ``sharded`` is a :class:`repro_torch.graph.shard.ShardedLayout` for
    ``mesh.size`` ranks and ``mesh`` this rank's
    :class:`repro_torch.dist.Mesh`; every rank builds the engine with the
    same arguments and calls the same methods in the same order.  The
    rank copies only its own slices of ``sharded.arrays()`` to its device.
    With the fused DC gather it derives there, once, the destination
    partitions' ranges of its received edges (``arrays["in_parts"]``,
    :func:`repro_torch.kernels.fused_step.part_ranges`), which raises if a
    valid edge lies outside its partition's range.
    ``mode``: 'dc', 'sc', 'hybrid' (Eq. 1 per iteration) or 'hybrid_pp'
    (Eq. 1 per partition).  ``plain=True`` runs the kernels' plain versions
    on any device."""

    def __init__(self, sharded, program: VertexProgram, mesh,
                 mode: str = "hybrid", bw_ratio: float = 2.0,
                 wire_bf16: bool = False, wire_bitmap: bool = True,
                 plain: bool = False):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
        if mesh.size != sharded.D:
            raise ValueError(f"the layout is sharded for D={sharded.D} ranks "
                             f"and the mesh has {mesh.size}")
        self.sl = sharded
        self.program = program
        self.mesh = mesh
        self.rank = mesh.rank
        self.device = dev = resolve_device(mesh.device)
        self.mode = mode
        self.bw_ratio = bw_ratio
        self.wire_bf16 = wire_bf16
        self.wire_bitmap = wire_bitmap
        # the bf16 wire engages only for f32 monoids; requesting it for the
        # integer id monoids (BFS/CC) stays exact
        self.wire_compressed = (wire_bf16
                                and program.monoid.dtype == torch.float32)
        D, nv, kpd = sharded.D, sharded.nv, sharded.kpd
        self.meta = dict(nv=nv, S=sharded.S, D=D, cap_in=sharded.cap_in,
                         cap_pair=sharded.cap_pair, kpd=kpd,
                         weighted=sharded.weighted)
        r = mesh.rank
        self.arrays = {key: torch.from_numpy(a[r]).to(dev)
                       for key, a in sharded.arrays().items()}
        self.arrays["oe_grp"] = _sc_groups(self.arrays["oe_group_off"],
                                           sharded.ne_s, D)
        self._lo = r * nv                       # the rank's first vertex
        self.deg = torch.from_numpy(
            sharded.deg[self._lo:self._lo + nv]).to(dev)        # int64[nv]

        fold = _resolve_fold(program, plain)
        fused = _resolve_fused(program, plain)
        self.fused = fused is not None
        if self.fused:
            self.arrays["in_parts"] = part_ranges(
                self.arrays["in_dst_local"], self.arrays["in_valid"],
                sharded.q, kpd)
        wire = dict(wire_bf16=wire_bf16, wire_bitmap=wire_bitmap)
        self._dc = build_dc_step(program, self.meta, mesh, fold=fold,
                                 fused=fused, **wire)
        self._dcb = build_dc_step(program, self.meta, mesh, fold=fold,
                                  fused=fused, batched=True, **wire)
        self._sc = build_sc_step(program, self.meta, mesh, fold=fold)
        self._hy = build_hybrid_step(program, self.meta, mesh, fold=fold)

        # Eq. 1, per (global) partition for hybrid_pp, and aggregated
        k_glob = D * kpd
        dc_cost = (sharded.part_msgs * 4 + k_glob * 4
                   + 2 * sharded.part_msgs * 4 + sharded.part_edges * 4)
        kk = len(sharded.part_edges)
        dcc = np.zeros(k_glob)
        dcc[:kk] = dc_cost
        ratio = sharded.part_msgs / np.maximum(sharded.part_edges, 1)
        scc = np.zeros(k_glob)
        scc[:kk] = 2 * ratio * 4 + 3 * 4
        self._cost_pp = CostModel(dc_cost=dcc, sc_coeff=scc,
                                  bw_ratio=bw_ratio)
        edges = float(sharded.part_edges.sum())
        self._dc_total = float(
            (sharded.part_msgs.sum() * 4 + sharded.part_edges.sum() * 4
             + 2 * sharded.part_msgs.sum() * 4))
        ratio = float(sharded.part_msgs.sum()) / max(edges, 1.0)
        self._sc_per_edge = 2 * ratio * 4 + 3 * 4

    # ---- shards --------------------------------------------------------
    def _shard(self, x):
        """The rank's ``[..., nv]`` slice of a global ``[..., D*nv]``
        tensor (or array), on its device."""
        x = torch.as_tensor(x, device=self.device)
        want = self.sl.D * self.sl.nv
        if x.shape[-1] != want:
            raise ValueError(f"expected [..., {want}] (D*nv) global vectors, "
                             f"got {tuple(x.shape)}")
        return x[..., self._lo:self._lo + self.sl.nv]

    def _unshard(self, x):
        """All-gather of every rank's ``[..., nv]`` shard into the global
        ``[..., D*nv]`` tensor, on every rank."""
        carrier = {torch.uint32: torch.int32, torch.bool: torch.uint8}.get(
            x.dtype, x.dtype)
        part = x.contiguous().view(carrier)
        parts = [torch.empty_like(part) for _ in range(self.mesh.size)]
        dist.all_gather(parts, part, group=self.mesh.group)
        return torch.cat(parts, -1).view(x.dtype)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- Eq. 1 ---------------------------------------------------------
    def _part_stats(self, active):
        """Per-(global)-partition active vertices and active out-edges
        (int64, summed over the ranks: the same host arrays everywhere)."""
        kpd, nv = self.sl.kpd, self.sl.nv
        q, k = nv // kpd, self.sl.D * kpd
        a = active.view(kpd, q)
        buf = torch.zeros(2, k, dtype=torch.int64, device=self.device)
        p0 = self.rank * kpd
        buf[0, p0:p0 + kpd] = a.sum(1)
        buf[1, p0:p0 + kpd] = (a * self.deg.view(kpd, q)).sum(1)
        dist.all_reduce(buf, group=self.mesh.group)
        counts, ea = buf.cpu().numpy()
        return counts, ea

    def _lane_counts(self, active):
        """Active vertices per lane, summed over the ranks (host)."""
        c = active.sum(1)
        dist.all_reduce(c, group=self.mesh.group)
        return c.cpu().numpy()

    def _choose_dc(self, e_active: int) -> bool:
        if self.mode == "dc":
            return True
        if self.mode == "sc":
            return False
        return self._dc_total <= self.bw_ratio * e_active * self._sc_per_edge

    # ---- runs ----------------------------------------------------------
    def run(self, state, frontier, max_iters: int = 10_000,
            until_empty: bool = True):
        """Host-driven loop with the per-iteration (or, in 'hybrid_pp',
        per-partition) Eq. 1 choice.  ``state`` maps names to global
        ``[D*nv]`` tensors and ``frontier`` is ``[D*nv]`` bool; returns
        ``(state, active, stats)`` with global tensors on every rank and
        ``stats`` the reference's per-iteration dicts (``it``,
        ``n_active``, ``e_active``, ``mode``, ``dc_parts`` and ``sc_parts``
        in 'hybrid_pp', ``wire_bytes``, ``wall_s``)."""
        state = {key: self._shard(v) for key, v in state.items()}
        active = self._shard(torch.as_tensor(frontier, dtype=torch.bool))
        kpd = self.sl.kpd
        stats = []
        for it in range(max_iters):
            counts, ea = self._part_stats(active)
            n_act, e_act = int(counts.sum()), int(ea.sum())
            if until_empty and n_act == 0:
                break
            t0 = time.perf_counter()
            if self.mode == "hybrid_pp":
                has = counts > 0
                dc_mask = self._cost_pp.choose_dc(ea, has)
                p0 = self.rank * kpd
                mine = torch.from_numpy(dc_mask[p0:p0 + kpd]).to(self.device)
                state, active = self._hy(state, active, self.arrays, it, mine)
                self._sync()
                sc_sel = (~dc_mask) & has
                # analytic wire: the full DC bin payload for the DC stream
                # and the per-active-edge SC payload of the SC partitions
                wire = (self.wire_bytes_per_step()
                        + int(self._sc_per_edge * int(ea[sc_sel].sum())))
                st = dict(it=it, n_active=n_act, e_active=e_act,
                          mode="hybrid_pp", dc_parts=int(dc_mask.sum()),
                          sc_parts=int(sc_sel.sum()), wire_bytes=wire,
                          wall_s=time.perf_counter() - t0)
            else:
                use_dc = self._choose_dc(e_act)
                fn = self._dc if use_dc else self._sc
                state, active = fn(state, active, self.arrays, it)
                self._sync()
                wire = (self.wire_bytes_per_step() if use_dc
                        else int(self._sc_per_edge * e_act))
                st = dict(it=it, n_active=n_act, e_active=e_act,
                          mode="dc" if use_dc else "sc", wire_bytes=wire,
                          wall_s=time.perf_counter() - t0)
            stats.append(st)
            self._record_iter(st)
        state = {key: self._unshard(v) for key, v in state.items()}
        return state, self._unshard(active), stats

    def run_fused(self, state, frontier, iters: int):
        """Fixed-iteration loop in DC mode with no host decisions (the
        PageRank path of :meth:`repro_torch.core.engine.Engine.run_fused`;
        the reference's ``DistEngine`` has none and runs PageRank through
        :meth:`run`).  While obs is on, rank 0 records a ``fused_run``
        event."""
        state = {key: self._shard(v) for key, v in state.items()}
        active = self._shard(torch.as_tensor(frontier, dtype=torch.bool))
        t0 = time.perf_counter()
        for it in range(iters):
            state, active = self._dc(state, active, self.arrays, it)
        if self.rank == 0 and obs.enabled():
            self._sync()
            obs.event("fused_run", engine="dist", program=self.program.name,
                      iters=iters, wall_s=time.perf_counter() - t0)
        state = {key: self._unshard(v) for key, v in state.items()}
        return state, self._unshard(active)

    def _record_iter(self, s: dict):
        """Telemetry for one distributed step, on rank 0 (a no-op when obs
        is off): an ``engine_iter`` event with the analytic wire bytes, the
        step-wall histogram keyed by mode, and an Eq. 1 cost sample."""
        if self.rank != 0 or not obs.enabled():
            return
        prog = self.program.name
        obs.event("engine_iter", engine="dist", program=prog, **s)
        obs.observe("engine.step_wall_s", s["wall_s"], engine="dist",
                    program=prog or "?", mode=s["mode"])
        obs.cost_sample(s["mode"], s["e_active"], s["wall_s"], it=s["it"],
                        engine="dist", program=prog,
                        wire_bytes=s["wire_bytes"])

    def wire_bytes_per_step(self, batch: int = 1) -> int:
        """Analytic per-rank all-to-all payload bytes of one DC step
        (values + validity flags) under this engine's wire config, for a
        live lane width of ``batch``."""
        return dc_wire_bytes(
            self.meta, self.program.monoid.dtype.itemsize,
            compressed=self.wire_compressed, wire_bitmap=self.wire_bitmap,
            batch=batch)

    def run_batched(self, states, frontiers, max_iters: int = 10_000,
                    until_empty: bool = True, collect_stats: bool = True):
        """Batched multi-source execution across the ranks: ``B``
        independent queries of this engine's program advance together, one
        batched DC superstep each iteration, whose bin exchange moves
        ``[B, D, S]`` in one all-to-all per payload.

        ``states`` leaves and ``frontiers`` are ``[B, D*nv]`` (the
        single-device ``*_multi`` state).  The union frontier, summed over
        the ranks, drives convergence; converged lanes are compacted out
        between steps at power-of-two widths
        (:func:`repro_torch.core.engine._run_batched_loop`), so every lane a
        step gets is live on some rank, and the reference's in-step freeze
        of converged lanes would change nothing.  DC mode only.  Results
        are bit-exact with B sequential :meth:`run` calls in ``mode='dc'``
        under the same wire config; ``stats`` are
        :class:`repro_torch.obs.schema.BatchIterStats`."""
        active = torch.as_tensor(frontiers, dtype=torch.bool)
        if active.dim() != 2:
            raise ValueError(f"frontiers must be [B, D*nv], got "
                             f"{tuple(active.shape)}")
        states = {key: self._shard(v) for key, v in states.items()}
        active = self._shard(active)

        def step(s, a, it):
            return self._dcb(s, a, self.arrays, it)

        quiet = (contextlib.nullcontext() if self.rank == 0
                 else obs.override_enabled(False))
        with quiet:
            states, active, stats = _run_batched_loop(
                step, states, active, max_iters, until_empty, collect_stats,
                engine_name="dist", program=self.program.name,
                wire_bytes_fn=self.wire_bytes_per_step,
                lane_counts=self._lane_counts)
        states = {key: self._unshard(v) for key, v in states.items()}
        return states, self._unshard(active), stats

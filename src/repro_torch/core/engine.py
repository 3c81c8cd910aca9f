"""The PPM engine: scatter → initFrontier → gather → filter, on torch tensors.

Counterpart of the single-device :class:`repro.core.engine.Engine` over a
partition-centric :class:`repro_torch.graph.layout.Layout`.  Each iteration
follows paper Alg. 3/4:

  1. *Scatter*, with a per-partition mode choice (Eq. 1 cost model, host
     NumPy, as in the reference):
       - **DC stream**, in one of the reference's two lowerings, chosen when
         the engine is built (``REPRO_FUSED``,
         :func:`repro_torch.kernels.fused_step.fused_enabled`):
           * fused (the default):
             :class:`repro_torch.kernels.ops.FusedDCKernel` gathers every
             gather-order edge's source value from the vertex message table
             and folds it into its destination;
           * composed (``REPRO_FUSED=0``, the paper's two phases, §3.3):
             :class:`repro_torch.kernels.ops.ScatterKernel` writes the
             values-only ``[NM]`` message bins, a slot gather reads them into
             the ``[NE]`` gather-order edge stream, and
             :class:`repro_torch.kernels.ops.GatherKernel` folds that stream
             into each destination partition, skipping the tiles of source
             partitions that are not in DC mode.
         Either way, edges whose source is inactive or in an SC-mode
         partition carry nothing.
       - **SC stream**: active vertices of SC-mode partitions are compacted
         (``nonzero``) and their CSR adjacency expanded into a
         ``(value, dst)`` message list of exactly the active edge count,
         then folded by :class:`repro_torch.kernels.ops.FoldKernel`.
  2. *initFrontier*: ``init_fn`` on active vertices → selective continuity.
  3. *Gather apply*: ``apply_fn`` updates touched vertices and proposes
     activations.
  4. *filterFrontier*: ``filter_fn`` on the union frontier.

The loop is driven from the host: each iteration reads the per-partition
active counts back for the Eq. 1 choice, as the reference's loop does, and
the SC compaction's ``nonzero`` syncs once more.  The reference pads the SC
stream to power-of-two budgets because XLA needs static shapes; here the
stream has exactly the active edge count, and an active SC vertex set with
no out-edges (the reference's degree-0 budget case) gives no stream.

:meth:`Engine.run_batched` advances ``B`` independent queries of one program
together, as the reference's vmapped step does: every state leaf and the
frontier carry a leading lane axis ``[B, n_pad]``, each superstep is DC-only
with the per-lane partition mask computed on the device, and every DC kernel
of the step runs once for all lanes in its lane form (one launch on a card).
Converged lanes are frozen inside a step and compacted out between steps
(:func:`_run_batched_loop`).

:meth:`Engine.run` also resumes from an old fixpoint after an
insertion-only graph delta (``resume_from=`` / ``touched=``, the
reference's incremental entry).

Telemetry (:mod:`repro_torch.obs`), as in the reference: ``run`` records an
``engine_iter`` event, a step-wall histogram and an Eq. 1 cost sample per
iteration it keeps stats for, the batched loop ``batch_iter`` and
``lane_compaction`` events, and ``run_fused`` a ``fused_run`` event.
Everything recorded is already on the host; only ``run_fused`` waits for the
card, and only while telemetry is on.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..graph.delta import DeltaBuffer
from ..kernels.fused_step import fused_enabled
from ..kernels.ops import (FoldKernel, FusedDCKernel, GatherKernel,
                           ScatterKernel)
from ..obs.schema import BatchIterStats, IterStats
from . import monoid as M
from .cost import CostModel
from .program import VertexProgram


def resolve_device(device) -> torch.device:
    """The engine's device; a CUDA device must exist, there is no fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def _tree_where(mask, new: dict, old: dict) -> dict:
    return {key: M.where(mask, new[key], old[key]) for key in old}


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x - 1).bit_length())


def _compact_lane_index(lane_act: np.ndarray, device="cpu"):
    """Surviving lane indices packed to the next power-of-two width, as an
    int64 tensor on ``device``, and that width.

    Padding repeats the first survivor, whose duplicate rows compute
    identical values, so scattering the packed results back is
    deterministic; the pow2 width keeps the set of step shapes at log2(B)
    + 1, which bounds what a captured step would have to cover."""
    idx_r = np.nonzero(lane_act)[0]
    width = _next_pow2(len(idx_r))
    idx = np.concatenate([idx_r, np.full(width - len(idx_r), idx_r[0])])
    return torch.from_numpy(idx.astype(np.int64)).to(device), width


def _take_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``x`` (any 4-byte dtype, ``uint32`` included)."""
    return M.from_bits(M.as_bits(x).index_select(0, idx), x.dtype)


def _put_lanes(x: torch.Tensor, idx: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """``x`` with rows ``idx`` replaced by ``rows``, through same-width
    bits: ``index_put_`` raises for ``uint32`` on the CPU."""
    return M.from_bits(M.as_bits(x).index_copy(0, idx, M.as_bits(rows)),
                       x.dtype)


def _lane_counts(active) -> np.ndarray:
    """Active vertices per lane of a ``[B, n]`` frontier, on the host."""
    return active.sum(1).cpu().numpy()


def _run_batched_loop(step, states: dict, active, max_iters: int,
                      until_empty: bool, collect_stats: bool,
                      engine_name: str = "core", program: str = "",
                      wire_bytes_fn=None, lane_counts=_lane_counts):
    """Host-driven batched convergence loop of :meth:`Engine.run_batched`
    (kept a module function, as in the reference, for the multi-device
    engine).

    ``step(states, active, it) -> (states, active)`` is one batched
    superstep over ``[W, ...]`` leaves, for any lane width ``W``.  The
    *union* frontier drives convergence: each step reads back the active
    count of each lane (``lane_counts(active)``, a ``[B]`` host array; the
    distributed engine's sums them over its ranks, so that every rank
    takes the same decisions).  A step with every lane live runs on the
    whole batch;
    otherwise the live lanes are packed to a power-of-two width
    (:func:`_compact_lane_index`), stepped, and scattered back.  With
    ``until_empty=False`` a step with no live lane is skipped.  Returns
    ``(states, active, stats)``, ``stats`` a list of
    :class:`BatchIterStats`.

    Telemetry, when obs is on: a ``lane_compaction`` event whenever lanes
    are repacked, and with ``collect_stats`` a ``batch_iter`` event, a
    step-wall histogram sample and a ``dc`` cost sample per step, all from
    host values the loop already holds.  ``wire_bytes_fn(n_lanes)``, when
    given, prices the step's exchange payload into the event."""
    B = active.shape[0]
    stats = []
    for it in range(max_iters):
        per_lane = lane_counts(active)
        lane_act = per_lane > 0
        n_lanes = int(lane_act.sum())
        if n_lanes == 0:
            if until_empty:
                break
            continue    # every phase masks on active: a no-op step
        t0 = time.perf_counter()
        n_act = int(per_lane.sum()) if collect_stats else 0
        if n_lanes == B:
            W = B
            states, active = step(states, active, it)
        else:
            # lane compaction: converged lanes drop out of the batch
            # instead of riding along as frozen work
            idx, W = _compact_lane_index(lane_act, active.device)
            if obs.enabled():
                obs.event("lane_compaction", engine=engine_name,
                          program=program, it=it, lanes_active=n_lanes,
                          width=W, batch=B)
            sub_states, sub_active = step(
                {key: _take_lanes(v, idx) for key, v in states.items()},
                active.index_select(0, idx), it)
            states = {key: _put_lanes(v, idx, sub_states[key])
                      for key, v in states.items()}
            active = active.index_copy(0, idx, sub_active)
        if active.is_cuda:
            torch.cuda.synchronize(active.device)
        wall = time.perf_counter() - t0
        if collect_stats:
            stats.append(BatchIterStats(
                it=it, lanes_active=n_lanes, n_active=n_act, wall_s=wall))
            if obs.enabled():
                extra = ({} if wire_bytes_fn is None else
                         {"wire_bytes": int(wire_bytes_fn(n_lanes))})
                obs.event("batch_iter", engine=engine_name,
                          program=program, it=it, lanes_active=n_lanes,
                          n_active=n_act, width=W, wall_s=wall, **extra)
                obs.observe("engine.batch_step_wall_s", wall,
                            engine=engine_name, program=program or "?")
                obs.cost_sample("dc", n_act, wall, it=it, batched=True,
                                width=W, engine=engine_name,
                                program=program)
    return states, active, stats


class Engine:
    """Single-device PPM engine.

    mode: 'hybrid' (paper's GPOP), 'dc' (GPOP_DC), 'sc' (GPOP_SC).
    device: 'cuda' (default) runs the CUDA kernels; 'cpu' runs their plain
    PyTorch versions.  plain=True runs the plain versions on any device.
    """

    def __init__(self, layout, program: VertexProgram, mode: str = "hybrid",
                 bw_ratio: float = 2.0, device="cuda", plain: bool = False):
        if mode not in ("hybrid", "dc", "sc"):
            raise ValueError(f"mode must be hybrid, dc or sc, not {mode!r}")
        self.device = resolve_device(device)
        self.layout = layout
        self.program = program
        self.mode = mode
        self.cost = CostModel.from_layout(layout, bw_ratio=bw_ratio)
        L, dev = layout, self.device
        self.k, self.q, self.n_pad = L.k, L.q, L.n_pad

        # device-resident CSR for the SC stream (sentinel row n_pad: degree 0)
        self.csr_indptr = torch.from_numpy(L.csr_indptr).to(dev)
        self.csr_indices = torch.from_numpy(L.csr_indices).to(dev)
        self.csr_w = (torch.from_numpy(L.csr_w).to(dev)
                      if L.csr_w is not None else None)
        self.deg = torch.from_numpy(L.deg).to(dev)              # int64[n_pad]

        mono = program.monoid
        self._fold = FoldKernel(mono.name, plain=plain)
        self.fused = fused_enabled()
        if self.fused:
            self._fused = FusedDCKernel(
                L, mono.name, mono.dtype, dev, plain=plain,
                apply_weight=(program.apply_weight if L.edge_w is not None
                              else None))
        else:
            self._scatter = ScatterKernel(L, mono.name, mono.dtype, dev,
                                          plain=plain)
            self._gather = GatherKernel(L, mono.name, mono.dtype, dev,
                                        plain=plain)
            self.png_src = torch.from_numpy(L.png_src).to(dev)       # [NM]
            self.msg_slot = torch.from_numpy(L.msg_slot).to(dev)     # [NE]
            self.edge_w = (torch.from_numpy(L.edge_w).to(dev)
                           if L.edge_w is not None else None)

    # ------------------------------------------------------------------
    def _part_stats(self, active):
        """Per-partition active vertices and active out-edges (host)."""
        a = active.view(self.k, self.q)
        counts = a.sum(1)
        ea = (a * self.deg.view(self.k, self.q)).sum(1)
        return counts.cpu().numpy(), ea.cpu().numpy()

    def sc_stream(self, msgs_p, sc_active, be: int):
        """The SC message list ``(vals, valid, dst)`` of the vertices in
        ``sc_active``: one message per out-edge, ``be`` in all, in CSR
        order."""
        prog = self.program
        ids = torch.nonzero(sc_active).squeeze(1)
        degs = self.deg[ids]
        cum = torch.cumsum(degs, 0)
        j = torch.arange(be, device=self.device)
        vi = torch.searchsorted(cum, j, right=True)
        src_v = ids[vi]
        e_idx = self.csr_indptr[src_v] + (j - (cum - degs)[vi])
        dst = self.csr_indices[e_idx]
        vals = M.from_bits(M.as_bits(msgs_p)[src_v], msgs_p.dtype)
        if prog.apply_weight is not None and self.csr_w is not None:
            vals = prog.apply_weight(vals, self.csr_w[e_idx]).to(
                prog.monoid.dtype)
        valid = torch.ones(be, dtype=torch.bool, device=self.device)
        return vals, valid, dst

    def composed_dc(self, msgs, dc_active, dc_parts):
        """The composed DC stream: ``(acc, touched)`` over ``[n_pad]``.

        ``dc_active`` marks the active vertices of DC-mode partitions and
        ``dc_parts`` the DC-mode partitions.  Scatter writes the message
        bins, the slot gather reads them into the gather-order edge stream
        (4-byte values moved through their ``int32`` bits, as in
        :meth:`sc_stream`), the edge function applies per edge, and the
        gather fold skips the tiles of source partitions not in DC mode.
        A slot is valid iff its source is in ``dc_active`` (the reference's
        ``active[png_src] & dc_mask[png_part]``); pad slots name the
        sentinel vertex ``n_pad``, which never is.  With a leading lane
        axis (``[B, n_pad]`` messages and activity, ``[B, k]`` DC
        partitions) every array carries it and the result is ``[B,
        n_pad]``; the slot gathers run along the last axis."""
        prog, mono, dev = self.program, self.program.monoid, self.device
        lead = tuple(msgs.shape[:-1])
        no = torch.zeros(lead + (1,), dtype=torch.bool, device=dev)
        ident = mono.identity_array(lead + (1,), dev)
        msg_data = self._scatter(msgs, dc_active)                    # [NM]
        dc_valid = torch.index_select(torch.cat([dc_active, no], -1), -1,
                                      self.png_src)                  # [NM]
        msg_data_p = torch.cat([M.as_bits(msg_data), M.as_bits(ident)], -1)
        dc_valid_p = torch.cat([dc_valid, no], -1)
        edge_vals = M.from_bits(
            torch.index_select(msg_data_p, -1, self.msg_slot), mono.dtype)
        edge_valid = torch.index_select(dc_valid_p, -1, self.msg_slot)
        if prog.apply_weight is not None and self.edge_w is not None:
            edge_vals = prog.apply_weight(edge_vals, self.edge_w).to(
                mono.dtype)
            edge_vals = M.where(edge_valid, edge_vals, ident)
        return self._gather(edge_vals, edge_valid, dc_parts)

    def step(self, state: dict, active, dc_mask: np.ndarray, it: int,
             be: int = 0):
        """One superstep.  ``dc_mask`` is the host's [k] bool DC-mode choice
        and ``be`` the active out-edges of the other partitions (the SC
        stream's length, known on the host from the Eq. 1 counts).  A stream
        with nothing to carry is not launched."""
        prog, mono, n_pad = self.program, self.program.monoid, self.n_pad
        dev = self.device
        msgs = prog.scatter_fn(state)
        if msgs.dtype != mono.dtype:
            msgs = msgs.to(mono.dtype)
        msgs_p = M.from_bits(torch.cat(
            [M.as_bits(msgs), M.as_bits(mono.identity_array((1,), dev))]),
            mono.dtype)

        # ---- initFrontier (selective continuity) ----
        if prog.init_fn is not None:
            st2, keep = prog.init_fn(state, it)
            state = _tree_where(active, st2, state)
            keep = keep & active
        else:
            keep = torch.zeros(n_pad, dtype=torch.bool, device=dev)

        dc_t = torch.from_numpy(dc_mask).to(dev)
        dc_v = dc_t.repeat_interleave(self.q)
        acc = touched = None
        # ---- DC stream over the dc_bin edges, fused or composed ----
        if dc_mask.any():
            if self.fused:
                no = torch.zeros(1, dtype=torch.bool, device=dev)
                acc, touched = self._fused(msgs_p,
                                           torch.cat([active & dc_v, no]))
                acc, touched = acc[:n_pad], touched[:n_pad]
            else:
                acc, touched = self.composed_dc(msgs, active & dc_v, dc_t)
        # ---- SC stream over the active vertices of SC-mode partitions ----
        if be > 0:
            stream = self.sc_stream(msgs_p, active & ~dc_v, be)
            acc2, touched2 = self._fold(*stream, n_pad + 1)
            acc2, touched2 = acc2[:n_pad], touched2[:n_pad]
            if acc is None:
                acc, touched = acc2, touched2
            else:
                acc, touched = mono.combine(acc, acc2), touched | touched2
        if acc is None:
            acc = mono.identity_array((n_pad,), dev)
            touched = torch.zeros(n_pad, dtype=torch.bool, device=dev)

        # ---- Gather apply ----
        st3, activated = prog.apply_fn(state, acc, touched, it)
        state = _tree_where(touched, st3, state)
        activated = activated & touched

        # ---- filterFrontier on the union frontier ----
        new_active = keep | activated
        if prog.filter_fn is not None:
            st4, fkeep = prog.filter_fn(state, it)
            state = _tree_where(new_active, st4, state)
            new_active = new_active & fkeep
        return state, new_active

    # ------------------------------------------------------------------
    def run(self, state: dict = None, frontier=None,
            max_iters: int = 10_000, until_empty: bool = True,
            collect_stats: bool = True, *, resume_from: dict = None,
            touched=None):
        """Host-driven loop: per-iteration mode decision (paper Eq. 1).

        ``resume_from=`` / ``touched=`` is the incremental entry for dynamic
        graphs: a state converged on the pre-delta layout resumes with the
        delta-touched vertices (a ``[n_pad]`` mask, or the
        :class:`repro_torch.graph.delta.DeltaBuffer` itself) as the initial
        frontier.  After an insertion-only delta a program of an idempotent
        monoid (``min``, ``max``, ``or``, ``min_with_payload``) converges
        to exactly the cold fixpoint of the new graph: the old fixpoint is
        an upper bound of the new one whose only violated constraints start
        at touched vertices (the reference's argument).  A delta with
        deletions, or another monoid, raises ``ValueError``: run cold, or
        warm-start PageRank through ``pagerank(pr0=)``.

        Returns ``(state, active, stats)``, ``stats`` a list of
        :class:`IterStats`, each also recorded as an ``engine_iter`` event
        while obs is on."""
        if resume_from is not None:
            if state is not None:
                raise ValueError("pass either state= or resume_from=, "
                                 "not both")
            if touched is None:
                raise ValueError("resume_from= needs touched= (the "
                                 "delta-touched initial frontier, or the "
                                 "DeltaBuffer itself)")
            # relaxation only lowers values, and a deleted edge may need
            # one to rise: resuming would converge to a stale answer
            if isinstance(touched, DeltaBuffer):
                if touched.num_deletes:
                    raise ValueError(
                        "resume_from= is exact only for insertion-only "
                        f"deltas; this delta removes {touched.num_deletes}"
                        " edge(s) and deleted edges may require values to "
                        "rise, which monotone relaxation cannot do: run "
                        "cold (state=/frontier=) on the new layout "
                        "instead")
                touched = touched.touched()
            if self.program.monoid.name not in ("min", "max", "or",
                                                "min_with_payload"):
                raise ValueError(
                    "resume_from= requires an idempotent monoid (min/max/"
                    f"or): re-folding under {self.program.monoid.name!r} "
                    "double-counts contributions already absorbed into "
                    "the old fixpoint; PageRank-style programs resume "
                    "through pagerank(pr0=) instead")
            state, frontier = resume_from, touched
        if state is None or frontier is None:
            raise ValueError("run() needs state+frontier (or "
                             "resume_from=+touched=)")
        active = torch.as_tensor(frontier, dtype=torch.bool,
                                 device=self.device)
        stats = []
        for it in range(max_iters):
            counts, ea = self._part_stats(active)
            n_active = int(counts.sum())
            if until_empty and n_active == 0:
                break
            has_active = counts > 0
            if self.mode == "dc":
                dc_mask = has_active
            elif self.mode == "sc":
                dc_mask = np.zeros(self.k, bool)
            else:
                dc_mask = self.cost.choose_dc(ea, has_active)
            sc_sel = (~dc_mask) & has_active
            sc_e = int(ea[sc_sel].sum())
            t0 = time.perf_counter()
            state, active = self.step(state, active, dc_mask, it, be=sc_e)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if collect_stats:
                b = self.cost.bytes_for(dc_mask, ea, has_active)
                dc_p, sc_p = int(dc_mask.sum()), int(sc_sel.sum())
                e_active = int(ea.sum())
                st = IterStats(
                    it=it, n_active=n_active, e_active=e_active,
                    dc_parts=dc_p, sc_parts=sc_p,
                    dc_bytes=b["dc_bytes"], sc_bytes=b["sc_bytes"],
                    wall_s=time.perf_counter() - t0,
                    mode=("dc" if sc_p == 0 else
                          "sc" if dc_p == 0 else "hybrid"),
                    program=self.program.name)
                stats.append(st)
                # dc_e / sc_e split the active edges by stream (a partition
                # with no active vertex has none): single-mode steps are
                # clean points for an Eq. 1 calibration
                obs.record_engine_iter("core", st, dc_e=e_active - sc_e,
                                       sc_e=sc_e)
        return state, active, stats

    # ------------------------------------------------------------------
    def batched_step(self, states: dict, active, it: int):
        """One superstep of ``W`` lanes (``[W, n_pad]`` leaves and
        frontier), the reference's vmapped DC-only step.

        Each lane's DC partitions are those with an active vertex (the mask
        ``run`` takes in mode 'dc'), computed on the device: no host read.
        The DC stream is one call of the fused kernel, or of the composed
        pair (``dc_gather`` and ``segment_combine``), for all lanes.  A lane
        with an empty frontier is frozen: its state and frontier come back
        unchanged."""
        prog, mono, n_pad = self.program, self.program.monoid, self.n_pad
        W, dev = active.shape[0], self.device
        live = active.any(1)                                       # [W]
        msgs = prog.scatter_fn(states)
        if msgs.dtype != mono.dtype:
            msgs = msgs.to(mono.dtype)

        # ---- initFrontier (selective continuity) ----
        new = states
        if prog.init_fn is not None:
            st2, keep = prog.init_fn(states, it)
            new = _tree_where(active, st2, states)
            keep = keep & active
        else:
            keep = torch.zeros_like(active)

        # ---- DC stream, every lane in its own DC partitions ----
        no = torch.zeros((W, 1), dtype=torch.bool, device=dev)
        if self.fused:
            # the table's validity is active & dc_mask[vert_part], which is
            # active itself when the DC partitions are those with an active
            # vertex
            msgs_p = M.from_bits(torch.cat(
                [M.as_bits(msgs),
                 M.as_bits(mono.identity_array((W, 1), dev))], 1),
                mono.dtype)
            acc, touched = self._fused(msgs_p, torch.cat([active, no], 1))
            acc, touched = acc[:, :n_pad], touched[:, :n_pad]
        else:
            # the scatter's [W, k, q] view needs whole rows (BFS's vid is
            # one row expanded over the lanes)
            dc_parts = active.view(W, self.k, self.q).any(2)        # [W, k]
            acc, touched = self.composed_dc(msgs.contiguous(), active,
                                            dc_parts)

        # ---- Gather apply ----
        st3, activated = prog.apply_fn(new, acc, touched, it)
        new = _tree_where(touched, st3, new)
        activated = activated & touched

        # ---- filterFrontier on the union frontier ----
        new_active = keep | activated
        if prog.filter_fn is not None:
            st4, fkeep = prog.filter_fn(new, it)
            new = _tree_where(new_active, st4, new)
            new_active = new_active & fkeep

        # ---- freeze converged lanes ----
        new = _tree_where(live[:, None], new, states)
        return new, new_active & live[:, None]

    def run_batched(self, states: dict, frontiers, max_iters: int = 10_000,
                    until_empty: bool = True, collect_stats: bool = True):
        """Batched multi-source execution: ``B`` independent queries of
        this engine's program advance together, one DC-only
        :meth:`batched_step` per superstep.

        ``states`` maps names to ``[B, n_pad]`` tensors (moved to the
        engine's device) and ``frontiers`` is ``[B, n_pad]`` bool.  The
        layout is shared; only the per-query state is replicated.  The loop
        (:func:`_run_batched_loop`) runs until every lane has drained,
        compacting converged lanes out between steps.  Results are
        bit-exact with ``B`` sequential :meth:`run` calls for min and max
        programs.  Returns ``(states, active, stats)``, ``stats`` a list of
        :class:`BatchIterStats`."""
        active = torch.as_tensor(frontiers, dtype=torch.bool,
                                 device=self.device)
        if active.dim() != 2:
            raise ValueError(f"frontiers must be [B, n_pad], got "
                             f"{tuple(active.shape)}")
        states = {key: torch.as_tensor(v, device=self.device)
                  for key, v in states.items()}
        return _run_batched_loop(self.batched_step, states, active,
                                 max_iters, until_empty, collect_stats,
                                 engine_name="core",
                                 program=self.program.name)

    # ------------------------------------------------------------------
    def run_fused(self, state: dict, frontier, iters: int):
        """Fixed-iteration loop in DC mode with no host round trips.

        This is the PageRank-style path: all partitions scatter DC every
        iteration (paper §6.2.2: "PageRank always uses DC mode").  While obs
        is on, the loop waits for the card at its end and records a
        ``fused_run`` event with its wall time; otherwise it returns
        without waiting."""
        active = torch.as_tensor(frontier, dtype=torch.bool,
                                 device=self.device)
        dc_mask = np.ones(self.k, bool)
        timed = obs.enabled()
        t0 = time.perf_counter()
        for it in range(iters):
            state, active = self.step(state, active, dc_mask, it)
        if timed:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            obs.event("fused_run", engine="core", program=self.program.name,
                      iters=iters, wall_s=time.perf_counter() - t0)
        return state, active

#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--scale 22]

Phases, in order; each prints lines that start with its name:

  device   the card's name and power limit (nvidia-smi), then the nvcc build
           of every CUDA kernel, all sources at once.
  graph    Graph500 RMAT (a=0.57, b=0.19, c=0.19, edge factor 16) at
           --scale from --seed, with edge weights, a symmetrized copy, and
           their layouts: k=128 partitions, so one destination partition's
           q=32768 accumulators fit one thread block's shared memory, and
           128 blocks for 132 SMs (paper §3.1 with this card's constants).
  kernels  each CUDA kernel against its plain PyTorch version on the card at
           the main path's shapes, every monoid x dtype on integer-valued
           payloads, bit-exact; times beside the bytes bound at 3.35 TB/s,
           the plain version's time, and where one PyTorch call computes the
           same function, that call's time (a yardstick the port never
           calls): ``Tensor.scatter_reduce_`` for the folds (and, for the
           segment fold, ``torch.full`` + ``scatter_reduce_`` into a fresh
           accumulator, the same work as the kernel's), a
           ``torch.sparse_csr_tensor`` product for the SpMV.  Each kernel
           time is given three ways: ``ms``, the median of single calls
           each between two CUDA events; ``device_ms``, CUDA events around
           a run of launches queued behind a ``torch.cuda._sleep``, so the
           card runs them back to back, over the count (device time alone);
           ``call_ms``, the host clock around a run of calls ending in a
           synchronize, over the count (host included); ``host_ms``, the
           same clock stopped before the synchronize (the host's time to
           issue a call).  The two tile kernels (``fused_dc``,
           ``segment_combine``) are checked on both of their paths (the
           ring of bulk copies, and plain loads on arrays off a 16-byte
           boundary), ``fused_dc`` with ``add_weight`` too, and timed in
           f32 add beside control rows on the same edges (i32 add, f32 min,
           plain loads; SSSP's f32 min with ``add_weight``).  The segment
           fold is timed on the main path's SC stream into n_pad + 1 and
           into 4096 segments, and at the tuner's ``fold2`` shape.
           ``dc_gather`` is checked in both of its regimes (staged, on the
           pieces ``ScatterKernel`` binds, and L2, without them) and timed
           through ``ScatterKernel``, beside ``torch.index_select`` of x
           over the slots' sources (one PyTorch call of the gather, without
           the select) and control rows that name their regime (half the
           sources active, the L2 regime at the same shape).  Then the
           composed DC step of
           PageRank timed whole and by part, its plain-torch slot gather
           included.  Then the lane forms of the batched engine (B queries
           in one launch, ``segment_combine_lanes`` and ``dc_gather_lanes``,
           or two, ``fused_dc_interleave`` then ``fused_dc_lanes`` over the
           layout's destination-sorted edge copy, whose bytes and build time
           are reported), each against its plain lane version at B = 4
           (every monoid x dtype) and 16, on both of its paths (or
           regimes), bit-exact, and timed at B = 16 at PageRank's shapes
           (and SSSP's for ``fused_dc``) beside their bound (the lanes'
           shared stream once, each lane's own bytes) and a yardstick: 16
           single-lane launches on the same lanes (for ``fused_dc``, also
           each of its two launches alone).  Then the 8-byte min of
           ``min_with_payload`` (int64 packed words: random non-negative
           f32 keys, +inf, any uint32 payload) in every kernel of its path:
           the segment fold into n_pad + 1 and into 4096 segments,
           ``fused_dc`` with no edge function and with
           ``add_weight_to_key``, ``dc_gather`` (staged in half rows, and
           L2) and ``segment_combine``, single-lane and at B = 4 and 16, on
           both paths, bit-exact, timed beside their 8-byte bound and
           ``scatter_reduce_(amin)`` of the same words (the segment fold
           also beside ``torch.full`` + ``scatter_reduce_`` + its touched
           flags; ``dc_gather`` beside ``torch.index_select``).
  apps     BFS and SSSP from the highest-degree vertex, CC on the
           symmetrized graph and PageRank (10 iterations through
           ``run_fused``, and 10 through ``run`` for per-iteration times),
           hybrid mode on the default device, each against a host oracle;
           hybrid BFS again through the plain versions on the card,
           bit-exact with the kernel run.  Then the same runs on the
           composed DC path (``REPRO_FUSED=0``: scatter into the bins, then
           gather), bit-exact with the fused runs (PageRank within L1
           1e-6).  Each path's kernels must have been launched by its runs,
           and every ``dc_gather`` launch of the composed runs staged.
           An engine's set-up on each DC lowering, whole and split into
           its host check, the fused kernel's check on the card, its
           host-to-card copies and the rest.
  baselines  the vertex-centric baselines (``repro_torch.baselines.vc``:
           plain torch over the edge list, no partitions): ``bfs_push``,
           ``bfs_pull`` and ``bfs_ec`` from the same vertex, ``sssp_push``
           on the weighted graph, ``pagerank_spmv`` (10 iterations) and
           ``cc_ec`` on the symmetrized graph, against the same host
           oracles, each wall beside the same app's GPOP wall above; none
           may launch a GPOP kernel.
  batched  ``bfs_multi`` and ``sssp_multi`` over 16 lanes (the highest-degree
           vertex and 15 sources spread over the vertex ids) on each DC
           lowering: every lane bit-exact with a sequential ``bfs`` /
           ``sssp`` on the card, the first lane with the host oracles, and
           each batched step exactly one launch of each lane kernel of its
           lowering (``dc_gather_lanes`` staged); wall, steps, lanes per
           step, compactions and peak device memory; the fused lane form's
           edge copy is built before the timed runs, with its time.
  payload  ``sssp_with_parents`` from the same vertex in hybrid mode on each
           DC lowering: distances bit-exact with ``sssp`` and within 1e-5 of
           Dijkstra, every parent's distance plus its edge's weight equal to
           the vertex's, and bit-exact with the plain versions on the card;
           then ``sssp_parents_multi`` (each lane against a sequential run)
           and a cold ``bfs_seeded_multi`` (against ``bfs_multi``) over the
           batched phase's 16 sources, each step one launch of each int64
           lane form of its lowering.
  serve    a ``GraphQueryServer`` on the symmetrized graph: three rounds of
           16 BFS, 16 SSSP and 4 SSSP-with-parents queries over 24 sources
           from --seed, then CC and PageRank; every answer against the same
           app run alone on the card, bit-exact (PageRank within L1 1e-6;
           an SSSP answer from a landmark-seeded lane, which the
           reference's seeding leaves within f32 rounding below the cold
           run, no higher than it and within rtol 1e-5), exact-cache
           hits and a landmark-seeded batch required, each int64 batched
           run one ``fused_dc_interleave`` and one ``fused_dc_lanes`` launch
           a step; per-app query walls
           (p50, p99) from the port's obs histograms, batch walls and
           widths, counters, seeded iterations saved, engine set-ups.
  delta    dynamic graphs, with deltas confined to the first ceil(0.05 k)
           partitions (benchmarks/bench_delta.py's confined_delta): 10,000
           insertions and 1,000 deletions of existing edges relaid out by
           ``apply_delta``, field for field a full ``build_layout`` of the
           edited graph (both walls); after 10,000 insertions, BFS (the
           packed seeded program) and SSSP from the same vertex resumed
           through ``Engine.run(resume_from=, touched=)`` on each DC
           lowering, bit-exact with cold runs on the new layout, and a
           deletion delta or a PageRank program refused before any launch;
           on the symmetrized graph after 10,000 symmetric insertions, CC
           resumed (bit-exact with cold) and PageRank warm-started (60
           iterations from 120 on the old graph, within max-abs 1e-6 and L1
           1e-5 of 160 cold ones); the serve phase's server swapped to the
           new layout with the delta (epoch bump, no old-tag key left, the
           clean landmarks migrated) and one round of 8 BFS and 8 SSSP
           queries checked as in serve.  Then telemetry: the run's event
           stream must hold every engine, delta and serve event and pass
           ``tools/check_obs_schema.py``; one PageRank iteration on each
           lowering under ``obs.trace`` must show the ``ppm.*.cuda`` scopes
           with their kernels' device records (beside the kernel rows'
           ``device_ms``); PageRank's ``run`` iteration and the fused DC
           wrapper's host time with telemetry on and off, and the host
           time of recording one iteration.
  local    Nibble, heat-kernel PageRank and PageRank-Nibble from the same
           vertex, in hybrid and in dc mode on each DC lowering, against the
           same app through the plain versions on the card within L1 1e-5,
           with both runs' iteration counts.
  dist     the multi-device engine on one NCCL rank (world size 1: NCCL
           refuses two ranks on one card, ``tools/probe_nccl_ranks.py``):
           ``shard_layout`` of both layouts timed beside ``build_layout``,
           ``DistEngine`` set-up split as ``engine_setup`` is; BFS, SSSP
           and CC in modes dc, sc, hybrid and hybrid_pp bit-exact with the
           single-device engine, PageRank (10 iterations, ``run`` and
           ``run_fused``) within L1 1e-6 and on the bf16 wire within the
           bound its 2**-9 rounding gives; ``bfs_multi`` and
           ``sssp_parents_multi`` over the batched phase's 16 sources, each
           lane bit-exact with a sequential dist run; the serve phase's
           first round again from a sharded ``GraphQueryServer``, each
           answer the unsharded server's (or, for a lane it seeded, the cold
           run's); every ``fused_stream`` launch of those runs in the
           partitioned regime; the layout-free ``fused_dc``
           (``csrc/fused_stream.cu``) at the dist DC step's shapes, every
           monoid and edge function bit-exact with its plain version in
           both regimes, f32 add and the int64 min with
           ``add_weight_to_key`` timed four ways in the partitioned regime
           over the engine's ranges (as the engine launches it) beside the
           stream regime (a control row), their bytes bound and
           ``index_add_`` / ``scatter_reduce_`` of pre-gathered values, and
           the share of the rank's valid edges whose dst repeats the
           previous one's;
           the dist DC step by part (scatter, exchange, fold) beside the
           single-device fused DC step, and one SC step in its dense and
           ragged forms (equal results), with the wire bytes.
  tuning   ``autotune`` over the card's four tile geometries on an RMAT
           graph of --scale - 2 (a quarter of the edges: the sweep builds a
           layout on the host a geometry), the sweep's times and winner,
           and ``build_layout`` with unset tiles reading the winner back
           from the cache.
  lm       the LM serving path (plain torch, eager): qwen2-0.5b (24 layers,
           d_model 896, vocab 151,936) and mamba2-780m (48 layers, d_inner
           3072, d_state 128) at full width and depth, random weights from
           --seed.  In f32 (TF32 off): 2 prompts of 64 tokens prefilled and
           8 greedy decode steps, every step's logits within LM_F32_ATOL of
           the full forward over the prompt and the generated tokens, and
           the same greedy tokens.  Then a bf16 ``Server`` on a copy of the
           weights: the launcher's workload (8 requests of 4-15 tokens, 4
           slots, max_len 256, max_new 16), its logits finite, within
           LM_BF16_ATOL of the bf16 full forward over each request's tokens
           and no farther from the f32 forward's than LM_BF16_NOISE_RATIO
           times the bf16 forward is; then, timed, 16 requests of 1024
           prompt tokens and 128 decode steps into 8 slots (vLLM's
           ``benchmark_serving.py`` random dataset at its default lengths),
           its greedy tokens the bf16 full forward's up to bf16 ties:
           prefill ms per request, decode ms per tick, tokens/s, peak
           device memory, and one tick and one prefill under
           torch.profiler.  Then every smoke config (the MoE, hybrid and
           frontend families among them) on the card against the CPU on
           the same weights, within LM_SMOKE_ATOL.

Launch counts are set to 0 before each path (fused apps, composed apps,
each batched, payload and local run, the serve stream, each resumed and
symmetrized delta run and the post-swap round, the dist phase's runs,
tuning, the baselines and the lm phase, which must launch none) and read
after it.  Then one JSON line with the kernels' numbers,
and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that line, as does a machine where torch sees no CUDA device.  The full
record, the compilers' register and shared-memory reports included, is
also written to ``--report`` (default ``results/chip_smoke.json``).
"""
import argparse
import collections
import copy
import dataclasses
import datetime
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory, NVIDIA data sheet
K_PARTS, EDGE_TILE, MSG_TILE = 128, 256, 128
MONOIDS = ("add", "min", "max")


class CheckFailed(Exception):
    pass


def say(phase: str, **fields):
    print(f"{phase} {json.dumps(fields)}", flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise CheckFailed(what)


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call times from CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int) -> float:
    """Device time of one call: CUDA events around ``reps`` calls queued
    behind a ``torch.cuda._sleep`` that holds the stream for twice the
    host's time to enqueue them, so the card runs them back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)   # ~2e9 cycles/s
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int) -> float:
    """Time of one call, host included: the host clock around ``reps``
    calls ending in a synchronize, over the count."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def host_ms(fn, reps: int) -> float:
    """Host time of one call: the host clock around ``reps`` calls, stopped
    before the synchronize, over the count (what issuing a call costs)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    return host_s * 1e3 / reps


def kernel_times(fn, reps: int) -> dict:
    """``ms`` (median single call between CUDA events), ``device_ms``,
    ``call_ms`` and ``host_ms`` of one kernel wrapper call."""
    return {"ms": median_ms(fn, reps), "device_ms": device_ms(fn, reps),
            "call_ms": call_ms(fn, reps), "host_ms": host_ms(fn, reps)}


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def scope_kernels(trace_path, names) -> dict:
    """The device kernel records a Chrome trace of ``torch.profiler``
    attributes to each ``ppm.*`` scope in ``names``: a kernel belongs to a
    scope when its launch record (runtime or driver API) with the same
    correlation id lies inside one of the scope's host ranges, or when a
    ``gpu_user_annotation`` of the scope holds it on the device timeline.
    Per scope: its host ranges, each kernel's summed device time (us) by
    name, and how many kernels each rule attributed."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}

    def inside(t, spans):
        return any(s["ts"] <= t <= s["ts"] + s["dur"] for s in spans)

    out = {}
    for name in names:
        host = [e for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation"]
        device = [e for e in events if e.get("name") == name
                  and e.get("cat") == "gpu_user_annotation"]
        rec = {"scopes": len(host), "gpu_annotations": len(device),
               "kernels": collections.Counter(),
               "by_launch": 0, "by_gpu_annotation": 0}
        for k in kernels:
            t = launch_ts.get(k.get("args", {}).get("correlation"))
            if t is not None and inside(t, host):
                rec["by_launch"] += 1
            elif inside(k["ts"], device):
                rec["by_gpu_annotation"] += 1
            else:
                continue
            rec["kernels"][k["name"]] += k["dur"]
        rec["kernels"] = dict(rec["kernels"])
        out[name] = rec
    return out


#: the LM phase's full-width configurations (one card each in f32)
LM_ARCHS = ("qwen2-0.5b", "mamba2-780m")
#: f32 prefill + decode against the full forward, on the card with TF32
#: off: the same products summed in other orders over 24-48 layers
LM_F32_ATOL = 1e-3
#: a smoke config's forward on the card against the CPU (TF32 off)
LM_SMOKE_ATOL = 1e-4
#: the bf16 Server's logits against the same model's bf16 full forward at
#: full width, a model each: products of other shapes, rounded to bf16 at
#: every layer.  Measured on an H100 (the launcher round): 0.044 for
#: qwen2-0.5b and 1.30 for mamba2-780m, whose random weights amplify
#: rounding: its bf16 forward is 1.98 from its f32 forward, on logits up
#: to 4.2 (qwen2-0.5b's: 0.065, up to 3.3).  Each limit is about twice its
#: reading.
LM_BF16_ATOL = {"qwen2-0.5b": 0.1, "mamba2-780m": 2.6}
#: the bf16 Server's logits may stray from the f32 forward's at most this
#: many times as far as the bf16 full forward does (measured 1.04 and 0.91)
LM_BF16_NOISE_RATIO = 1.5
#: the launcher's LM workload (``launch/serve.py``'s defaults): the bf16
#: Server's smoke check
LAUNCHER_ROUND = {"requests": 8, "slots": 4, "max_len": 256, "max_new": 16}
#: the timed round, at serving size: every request 1024 prompt tokens and
#: 128 decode steps; 16 requests into 8 slots
SERVING_ROUND = {"requests": 16, "slots": 8, "prompt": 1024, "max_new": 128}
SERVING_SOURCE = ("vLLM benchmarks/benchmark_serving.py --dataset-name "
                  "random at its defaults (--random-input-len 1024, "
                  "--random-output-len 128); 16 of its 1000 prompts")


def device_profile(fn, dev) -> dict:
    """One call of ``fn`` (after one warm-up call) under torch.profiler:
    its host wall (profiler overhead included), the CUDA kernels its trace
    holds, their summed device time, and the aten ops it issued."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e["dur"] for e in kernels) / 1e3
    return {"wall_ms": wall * 1e3, "kernels": len(kernels),
            "device_busy_ms": busy,
            "aten_ops": sum(1 for e in events if e.get("cat") == "cpu_op"
                            and e.get("name", "").startswith("aten::"))}


def bf16_round(model, cfg, dev, prompts, *, slots, max_len, max_new,
               keep_logits=False) -> dict:
    """``prompts`` through a bf16 ``Server`` of ``slots`` slots, each for
    ``max_new`` decode steps: the finished requests by id, the walls of its
    prefills and decode ticks (the server's ``on_wall``), the run's wall
    and the peak device memory from the server's construction on."""
    import torch
    from repro_torch.serve import Request, Server
    walls = {"prefill": [], "decode": []}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    srv = Server(model, n_slots=slots, max_len=max_len, dtype=torch.bfloat16,
                 on_wall=lambda kind, s: walls[kind].append(s),
                 keep_logits=keep_logits)
    for r, prompt in enumerate(prompts):
        srv.submit(Request(rid=r, prompt=prompt, max_new=max_new))
    t = time.perf_counter()
    done = sorted(srv.run(), key=lambda d: d.rid)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    check([d.rid for d in done] == list(range(len(prompts)))
          and all(len(d.out) == max_new + 1 for d in done),
          f"{cfg.name}: the server did not return {max_new + 1} tokens a "
          "request")
    return {"server": srv, "done": done, "walls": walls, "wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def hold_to_full_forward(model, ref32, cfg, dev, done, atol) -> dict:
    """Each finished request of a bf16 server on ``model`` against
    ``model``'s own full forward (bf16) over its prompt and its tokens but
    the last.  The server's token at each position is the bf16 forward's
    greedy token, or one whose logit there lies within 2 x ``atol`` of the
    largest (a tie at bf16 rounding: two sets of logits within ``atol`` of
    each other allow no more).  Where
    the server kept its logits, they must be finite, within ``atol`` of the
    bf16 forward's, and no farther from ``ref32``'s (the same weights in
    f32) than LM_BF16_NOISE_RATIO times the bf16 forward's own distance
    from them (``noise``)."""
    import torch
    rec = {"positions": 0, "tokens_differ": 0, "max_gap": 0.0,
           "max_abs_err": None, "noise": None, "max_abs_err_f32": None,
           "max_abs_logit": 0.0, "atol": atol,
           "noise_ratio": LM_BF16_NOISE_RATIO}

    def logits(m, seq, P):
        with torch.no_grad():
            x = m.backbone(m.embed_tokens(seq),
                           torch.arange(seq.shape[1], device=dev))
            return m.lm_logits(x[:, P - 1:])[0]          # [max_new + 1, V]

    def most(key, v):
        rec[key] = max(rec[key] or 0.0, float(v))

    for d in done:
        P = len(d.prompt)
        seq = torch.as_tensor(np.concatenate([d.prompt, d.out[:-1]]),
                              dtype=torch.int64, device=dev)[None]
        full = logits(model, seq, P)
        check(bool(torch.isfinite(full).all()), f"{cfg.name}: the bf16 full "
              "forward's logits are not finite")
        out = torch.as_tensor(d.out, device=dev)
        gap = full.amax(-1) - full.gather(1, out[:, None])[:, 0]
        rec["positions"] += len(d.out)
        rec["tokens_differ"] += int((full.argmax(-1) != out).sum())
        most("max_gap", gap.max())
        most("max_abs_logit", full.abs().max())
        if d.logits is not None:
            got, full32 = torch.stack(d.logits), logits(ref32, seq, P)
            check(bool(torch.isfinite(got).all()), f"{cfg.name}: the "
                  "server's logits are not finite")
            most("noise", (full - full32).abs().max())
            most("max_abs_err", (got - full).abs().max())
            most("max_abs_err_f32", (got - full32).abs().max())
    check(rec["max_gap"] <= 2 * atol, f"{cfg.name}: a server token's logit "
          f"is {rec['max_gap']} below the bf16 full forward's largest "
          f"(> 2 x {atol})")
    if rec["max_abs_err"] is not None:
        check(rec["max_abs_err"] <= atol, f"{cfg.name}: the server's logits "
              f"are {rec['max_abs_err']} from the bf16 full forward's "
              f"(> {atol})")
        check(rec["max_abs_err_f32"] <= LM_BF16_NOISE_RATIO * rec["noise"],
              f"{cfg.name}: the server's logits are {rec['max_abs_err_f32']}"
              f" from the f32 forward's, more than {LM_BF16_NOISE_RATIO} x "
              f"the bf16 forward's {rec['noise']}")
    return rec


def serve_lm(model, ref32, cfg, dev, seed, base):
    """The bf16 ``Server`` on ``model`` (cast in place), twice, held to the
    full forwards of ``model`` and ``ref32`` (the same weights in f32;
    :func:`hold_to_full_forward`).  First the launcher's workload
    (LAUNCHER_ROUND: prompts of 4-15 tokens drawn from ``default_rng(seed)``
    as ``launch/serve.py`` draws them), its logits kept: the smoke check,
    and the warm-up (its times are a first call's).  Then SERVING_ROUND, timed, its tokens checked: each
    prefill and decode tick (the server's own walls, ending in the argmax's
    copy to the host), the run's wall, tokens/s, and the peak device memory
    from the server's construction on less ``base`` (what earlier phases
    and ``ref32`` hold); then one decode tick of all slots and one prefill
    of a SERVING_ROUND prompt under torch.profiler."""
    import torch
    from repro_torch.serve import engine as serve
    rng = np.random.default_rng(seed)
    lr = LAUNCHER_ROUND
    smoke = bf16_round(
        model, cfg, dev, [rng.integers(0, cfg.vocab, rng.integers(4, 16),
                                       dtype=np.int32)
                          for _ in range(lr["requests"])],
        slots=lr["slots"], max_len=lr["max_len"], max_new=lr["max_new"],
        keep_logits=True)
    rec = {"launcher_round": dict(
        lr, **round_times(smoke),
        check=hold_to_full_forward(model, ref32, cfg, dev, smoke["done"],
                                   LM_BF16_ATOL[cfg.name]),
        out_first_request=smoke["done"][0].out)}
    del smoke

    sr = SERVING_ROUND
    max_len = sr["prompt"] + sr["max_new"]
    prompts = rng.integers(0, cfg.vocab, (sr["requests"], sr["prompt"]),
                           dtype=np.int32)
    run = bf16_round(model, cfg, dev, list(prompts), slots=sr["slots"],
                     max_len=max_len, max_new=sr["max_new"])
    check_rec = hold_to_full_forward(model, ref32, cfg, dev, run["done"],
                                     LM_BF16_ATOL[cfg.name])
    # where a tick's time goes: one more decode tick of every slot (past
    # the ring's end: the times, not the tokens, are read), and a one-row
    # prefill of a SERVING_ROUND prompt, each under torch.profiler
    srv, bf16 = run["server"], torch.bfloat16
    toks = torch.as_tensor(srv._next_tok, device=dev)
    prompt = torch.as_tensor(prompts[:1], dtype=torch.int64, device=dev)
    with torch.no_grad():
        profiles = {
            "decode_tick": device_profile(lambda: serve.decode_step(
                srv.model, toks, srv.cache), dev),
            f"prefill_{sr['prompt']}": device_profile(lambda: serve.prefill(
                srv.model, {"tokens": prompt},
                serve.init_cache(cfg, 1, max_len, bf16, dev)), dev)}
    rec["serving_round"] = dict(
        sr, source=SERVING_SOURCE, **round_times(run),
        peak_bytes=run["peak_bytes"] - base, check=check_rec,
        profiles=profiles)
    return rec


def round_times(run) -> dict:
    """A :func:`bf16_round`'s wall, tokens/s and its walls' medians."""
    walls = run["walls"]
    tokens = sum(len(d.out) for d in run["done"])
    return {"wall_s": run["wall_s"], "tokens": tokens,
            "tokens_per_s": tokens / run["wall_s"],
            "prefill_ms_median": float(np.median(walls["prefill"])) * 1e3,
            "prefill_ms_max": float(np.max(walls["prefill"])) * 1e3,
            "decode_ticks": len(walls["decode"]),
            "decode_ms_median": float(np.median(walls["decode"])) * 1e3,
            "decode_ms_mean": float(np.mean(walls["decode"])) * 1e3}


def lm_phase(dev, seed) -> dict:
    """The LM serving path: each of LM_ARCHS at full width in f32 (2
    prompts of 64 tokens prefilled, 8 greedy decode steps, every step's
    logits against the full forward of the prompt and the generated tokens,
    and the same greedy tokens), then the bf16 ``Server`` on the same
    weights (:func:`serve_lm`); then every smoke config's forward (and
    prefill + decode where it decodes) on the card against the CPU on the
    same weights."""
    import torch
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.serve import decode_step, init_cache, prefill
    f32 = torch.float32
    rec = {}
    for arch in LM_ARCHS:
        cfg = configs.get_config(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        t = time.perf_counter()
        model = LM(cfg, device=dev, generator=gen)
        torch.cuda.synchronize(dev)
        r = {"layers": cfg.n_layers, "d_model": cfg.d_model,
             "vocab": cfg.vocab,
             "params": sum(p.numel() for p in model.parameters()),
             "config_param_count": cfg.param_count(),
             "init_s": time.perf_counter() - t}
        rng = np.random.default_rng(seed)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
        with torch.no_grad():
            t = time.perf_counter()
            cache = init_cache(cfg, 2, 128, dtype=f32, device=dev)
            lg, cache = prefill(model, {"tokens": prompt}, cache)
            steps, toks = [lg], [lg.argmax(-1)]
            for _ in range(8):
                lg, cache = decode_step(model, toks[-1], cache)
                steps.append(lg)
                toks.append(lg.argmax(-1))
            torch.cuda.synchronize(dev)
            r["f32_prefill_decode_s"] = time.perf_counter() - t
            seq = torch.cat([prompt, torch.stack(toks[:-1], 1)], 1)
            full = model(seq)[:, 63:]
            got = torch.stack(steps, 1)
            r.update(f32_max_abs_err=float((got - full).abs().max()),
                     f32_max_abs_logit=float(full.abs().max()),
                     f32_atol=LM_F32_ATOL,
                     greedy_equal=bool(torch.equal(full.argmax(-1),
                                                   torch.stack(toks, 1))),
                     f32_peak_bytes=torch.cuda.max_memory_allocated(dev)
                     - base)
        check(bool(torch.isfinite(got).all()), f"{arch}: f32 logits not "
              "finite")
        check(r["f32_max_abs_err"] <= LM_F32_ATOL,
              f"{arch}: prefill + decode is {r['f32_max_abs_err']} from the "
              f"full forward (> {LM_F32_ATOL})")
        check(r["greedy_equal"], f"{arch}: the greedy tokens differ from the "
              "full forward's")
        del cache, full, got, steps, seq
        # the server casts a copy; the f32 model stays as its yardstick
        # and, with earlier phases, is left out of the server's peak
        base = torch.cuda.memory_allocated(dev)
        r["server_bf16"] = serve_lm(copy.deepcopy(model), model, cfg, dev,
                                    seed, base)
        rec[arch] = r
        say("lm", arch=arch, **r)
        del model
        torch.cuda.empty_cache()

    smoke = {}
    for arch in configs.ARCHS:
        cfg = configs.get_smoke_config(arch)
        cpu = LM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
        card = LM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(seed)
        if cfg.frontend is not None:
            inputs = {"embeds": torch.from_numpy(rng.normal(
                size=(2, 12, cfg.d_model)).astype(np.float32))}
        else:
            inputs = {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab, (2, 12)))}
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 3)))
        outs = []
        with torch.no_grad():
            for model, d in ((cpu, torch.device("cpu")), (card, dev)):
                on = {k: v.to(d) for k, v in inputs.items()}
                seq = [model(on.get("tokens"), embeds=on.get("embeds"))]
                if cfg.decoder:
                    cache = init_cache(cfg, 2, 32, dtype=f32, device=d)
                    lg, cache = prefill(model, on, cache)
                    seq.append(lg)
                    for i in range(3):
                        lg, cache = decode_step(model, nxt[:, i].to(d), cache)
                        seq.append(lg)
                outs.append([x.cpu() for x in seq])
        err = max(float((a - b).abs().max()) for a, b in zip(*outs))
        smoke[arch] = {"family": cfg.family, "max_abs_err": err,
                       "decode_steps": 3 if cfg.decoder else 0}
        check(err <= LM_SMOKE_ATOL, f"{arch} smoke: the card is {err} from "
              f"the CPU (> {LM_SMOKE_ATOL})")
        say("lm", smoke=arch, **smoke[arch])
    rec["smoke_card_vs_cpu"] = smoke
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--report", default=str(ROOT / "results" /
                                            "chip_smoke.json"),
                    help="where to write the full record (JSON)")
    args = ap.parse_args()
    started = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    import repro_torch as rt
    from repro_torch.backend import tuning
    from repro_torch.core import monoid as M
    from repro_torch.graph import build_layout, rmat, symmetrize, to_scipy
    from repro_torch.kernels import _build
    from repro_torch.kernels.dc_gather import dc_gather, ref_dc_gather
    from repro_torch.kernels.fold_block import (blocked_segment_fold,
                                                segment_fold)
    from repro_torch.kernels import ops
    from repro_torch.kernels import fused_step
    from repro_torch.kernels.fused_step import (ENV_FUSED, EdgeTiles,
                                                add_weight,
                                                add_weight_to_key,
                                                build_lane_edges,
                                                fused_scatter_fold,
                                                global_edges, lane_group,
                                                lane_width,
                                                ref_fused_scatter_fold,
                                                ref_interleave_lanes)
    from repro_torch.kernels.ops import (FusedDCKernel, GatherKernel,
                                         ScatterKernel, SpmvKernel)
    from repro_torch.kernels.segment_combine import (ref_segment_combine,
                                                     segment_combine)
    from repro_torch.kernels.spmv_block import ref_spmv_block, spmv_block

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"args": vars(args)}
    dtypes = {"float32": torch.float32, "int32": torch.int32,
              "uint32": torch.uint32}

    # ---------------- device ----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    report["device"] = {"nvidia_smi": smi, "torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "build_s": time.perf_counter() - t0}
    say("device", **report["device"])
    report["ptxas"] = {k.name: k.build_log for k in _build.KERNELS}

    # ---------------- graph ----------------
    t0 = time.perf_counter()
    g = rmat(args.scale, 16, seed=args.seed, weighted=True)
    t_gen = time.perf_counter() - t0
    L = build_layout(g, k=K_PARTS, edge_tile=EDGE_TILE, msg_tile=MSG_TILE)
    t_lay = time.perf_counter() - t0 - t_gen
    gs = symmetrize(g)
    S = build_layout(gs, k=K_PARTS, edge_tile=EDGE_TILE, msg_tile=MSG_TILE)
    report["graph"] = {
        "scale": args.scale, "n": g.n, "m": g.m, "m_sym": gs.m,
        "k": L.k, "q": L.q, "num_edges_padded": L.num_edges,
        "num_edges_padded_sym": S.num_edges, "rmat_s": t_gen,
        "layout_s": t_lay,
        "sym_and_layout_s": time.perf_counter() - t0 - t_gen - t_lay}
    part_edges = np.diff(L.blk_off[::L.k])   # edges per destination partition
    report["graph"]["part_edges_max_over_mean"] = float(
        part_edges.max() / part_edges.mean())
    say("graph", **report["graph"])
    src = int(np.argmax(g.out_degrees()))
    n_pad, ns = L.n_pad, L.n_pad + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def payload(n, dtype):
        lo = 0 if dtype == torch.uint32 else -64
        x = torch.randint(lo, 64, (n,), generator=gen, device=dev)
        if dtype == torch.uint32:
            return x.to(torch.int32).view(torch.uint32)
        return x.to(dtype)

    def bits(x):
        return (x.view(torch.int32)
                if x.dtype not in (torch.bool, torch.int64) else x)

    def unaligned(t):
        """A copy of ``t`` that starts one element past a 16-byte boundary:
        the tile kernels take plain loads for it, not the ring."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t)
        return buf[1:]

    def max_abs_err(got, want, what):
        """Every output of a kernel bit-exact with its plain version's:
        values (the largest absolute difference, 0.0 when they agree) and
        touched flags."""
        (ga, *gts), (wa, *wts) = got, want
        check(ga.dtype == wa.dtype and ga.shape == wa.shape, f"{what}: shape")
        same = bits(ga) == bits(wa)
        diff = (M.widen(ga).double() - M.widen(wa).double()).abs()
        err = float(torch.where(same, 0.0, diff).max()) if ga.numel() else 0.0
        check(bool(same.all()), f"{what}: acc differs, max abs err {err}")
        for gt, wt in zip(gts, wts):
            check(torch.equal(gt, wt), f"{what}: touched differs")
        return err

    # ---------------- kernels ----------------
    # The fused DC kernel reads the layout's tile form; its plain version
    # reads the global idx and dst, built here from the tiles on the card.
    kern = FusedDCKernel(L, "add", torch.float32, dev,
                         apply_weight=add_weight)    # the layout's weights
    tiles, edge_valid = kern.tiles, kern.edge_valid
    idx, edge_dst = global_edges(
        kern.tile_src_part, kern.tile_dst_part, kern.edge_src_local,
        kern.edge_dst_local, edge_valid, q=L.q, edge_tile=L.edge_tile,
        n_pad=n_pad)
    ne = L.num_edges
    w_int = payload(ne, torch.float32)       # integer weights: exact sums
    # each path's (tiles, edge_valid, {weights}): the ring, and plain loads
    # on arrays that start off a 16-byte boundary
    fused_paths = {
        "ring": (tiles, edge_valid, {"layout": kern.edge_w, "int": w_int}),
        "plain_loads": (
            EdgeTiles(unaligned(tiles.edge_src_local),
                      unaligned(tiles.edge_dst_local), *tiles[2:]),
            unaligned(edge_valid), {"layout": unaligned(kern.edge_w),
                                    "int": unaligned(w_int)})}
    fused_cases = [(m, d, None, None) for m in MONOIDS for d in dtypes]
    fused_cases += [("min", "float32", add_weight, "layout"),   # SSSP's
                    ("add", "float32", add_weight, "int")]
    fused_err = 0.0
    for path, (tl, ev, ws) in fused_paths.items():
        for monoid, dname, fn, wkey in fused_cases:
            dtype = dtypes[dname]
            table = payload(ns, dtype)
            tvalid = torch.rand(ns, generator=gen, device=dev) < 0.5
            got = fused_scatter_fold(
                table, tvalid, None, ev, None, ns, monoid=monoid, tiles=tl,
                apply_weight=fn, w=ws[wkey] if fn else None)
            want = ref_fused_scatter_fold(
                M.REGISTRY[monoid](dtype), table, tvalid, idx, edge_valid,
                edge_dst, ns, apply_weight=fn,
                w=fused_paths["ring"][2][wkey] if fn else None)
            fused_err = max(fused_err, max_abs_err(
                got, want, f"fused_dc {path} {monoid} {dname}"
                + (" add_weight" if fn else "")))

    # timed at PageRank's step: f32 add, every source live; beside it the
    # same edges in i32 add and f32 min (native shared atomics, no hub
    # cache), through plain loads, and at SSSP's step (f32 min, add_weight)
    all_valid = torch.ones(ns, dtype=torch.bool, device=dev)
    tables = {"float32": payload(ns, torch.float32),
              "int32": payload(ns, torch.int32)}

    def fused_call(monoid="add", dname="float32", path="ring", fn=None):
        tl, ev, ws = fused_paths[path]
        return lambda: fused_scatter_fold(
            tables[dname], all_valid, None, ev, None, ns, monoid=monoid,
            tiles=tl, apply_weight=fn, w=ws["layout"] if fn else None)

    fused_t = kernel_times(fused_call(), 20)
    fused_ms = fused_t["ms"]
    fused_controls = {
        "i32_add": kernel_times(fused_call(dname="int32"), 20),
        "f32_min": kernel_times(fused_call("min"), 20),
        "f32_add_plain_loads": kernel_times(fused_call(path="plain_loads"),
                                            20),
        "f32_min_add_weight": kernel_times(fused_call("min", fn=add_weight),
                                           20)}
    fused_plain_ms = median_ms(lambda: ref_fused_scatter_fold(
        M.add(torch.float32), tables["float32"], all_valid, idx, edge_valid,
        edge_dst, ns), 3)
    # the yardstick, as the [flat] rows': index_add_ of the values the
    # kernel folds, gathered beforehand (untimed)
    lib_vals = torch.where(edge_valid.to(torch.bool),
                           tables["float32"][idx.to(torch.int64)], 0.0)
    lib_dst = edge_dst.to(torch.int64)
    lib_acc = torch.zeros(ns, device=dev)
    fused_library_ms = median_ms(
        lambda: lib_acc.index_add_(0, lib_dst, lib_vals), 20)
    del lib_vals, lib_dst, lib_acc
    nt = L.num_edge_tiles
    fused_bytes = ns * (4 + 1) + ne * (4 + 4 + 1) + nt * 4 + (L.k + 1) * 8 \
        + ns * (4 + 1)
    report["fused_dc"] = {
        "shape": {"table": ns, "edges": ne, "edge_tiles": nt, "k": L.k,
                  "q": L.q},
        "case": "add float32, all sources live", **fused_t,
        "plain_ms": fused_plain_ms, "bytes": fused_bytes,
        "bound_ms": bound_ms(fused_bytes), "max_abs_err": fused_err,
        "library_ms": fused_library_ms, "controls": fused_controls}
    say("kernels", name="fused_dc", **report["fused_dc"])
    del fused_paths, tables, w_int, idx

    # The fold's shape: the largest SC stream of the hybrid BFS run below.
    # BFS's frontier at superstep i is the level-i set, and the engine's
    # per-partition Eq. 1 choice is host NumPy on its counts, so both are
    # known here before the run.
    P1 = sp.csr_matrix((np.ones(g.m, np.float32), g.indices, g.indptr),
                       shape=(g.n, g.n))
    bfs_eng = rt.Engine(L, rt.apps.bfs_program())
    frontier, seen, sc_iters = np.array([src]), np.zeros(g.n, bool), []
    seen[src] = True
    while len(frontier):
        mask = np.zeros(n_pad, bool)
        mask[frontier] = True
        part = mask.reshape(L.k, L.q)
        counts = part.sum(1)
        ea = (part * L.deg.reshape(L.k, L.q)).sum(1)
        dc = bfs_eng.cost.choose_dc(ea, counts > 0)
        sc_sel = ~dc & (counts > 0)
        sc_iters.append((int(ea[sc_sel].sum()), len(sc_iters),
                         mask & np.repeat(sc_sel, L.q), int(sc_sel.sum())))
        nxt = np.unique(P1[frontier].indices)
        frontier = nxt[~seen[nxt]]
        seen[frontier] = True
    be, fold_iter, sc_mask, _ = max(sc_iters, key=lambda t: t[0])
    vid = torch.arange(ns, dtype=torch.int32, device=dev).view(torch.uint32)
    _, _, dst = bfs_eng.sc_stream(vid, torch.from_numpy(sc_mask).to(dev), be)
    del bfs_eng
    valid = torch.rand(be, generator=gen, device=dev) < 0.9
    # and the tuner's fold2 row: the layout's edge count of sorted ids into
    # FOLD_CAP * 3/2 + 1 segments, invalid edges at the last (tuning.py)
    ns2 = tuning.FOLD_CAP + tuning.FOLD_CAP // 2 + 1
    ev = torch.from_numpy(L.edge_valid.astype(bool)).to(dev)
    ids2 = torch.sort(torch.randint(0, ns2 - 1, (L.num_edges,),
                                    generator=gen, device=dev)).values
    ids2 = torch.where(ev, ids2, ns2 - 1).to(torch.int32)
    fold_err, fold_rows = 0.0, {}
    for key, fold_ns, fvalid, ids in (
            ("ids_mod_4096", 4096, valid, dst % 4096),
            ("n_pad_plus_1", ns, valid, dst),
            ("fold2", ns2, ev, ids2)):
        m = ids.shape[0]
        for monoid in MONOIDS:
            for dname, dtype in dtypes.items():
                vals = payload(m, dtype)
                fold_err = max(fold_err, max_abs_err(
                    blocked_segment_fold(vals, fvalid, ids, fold_ns,
                                         monoid=monoid),
                    segment_fold(vals, fvalid, ids, fold_ns, monoid),
                    f"segment_fold {monoid} {dname} ns={fold_ns}"))
        # timed at SSSP's fold: f32 min
        vals = payload(m, torch.float32)
        masked = torch.where(fvalid, vals, float("inf"))
        ids64 = ids.to(torch.int64)
        lib_acc = torch.full((fold_ns,), float("inf"), device=dev)

        def library():
            return lib_acc.scatter_reduce_(0, ids64, masked, "amin",
                                           include_self=True)

        def library_fill():
            return torch.full((fold_ns,), float("inf"),
                              device=dev).scatter_reduce_(
                0, ids64, masked, "amin", include_self=True)

        fold_bytes = m * (4 + 1 + 4) + fold_ns * (4 + 1)
        fold_rows[key] = {
            "shape": {"messages": m, "num_segments": fold_ns},
            "case": "min float32",
            **kernel_times(lambda: blocked_segment_fold(
                vals, fvalid, ids, fold_ns, monoid="min"), 20),
            "plain_ms": median_ms(lambda: segment_fold(
                vals, fvalid, ids, fold_ns, "min"), 3),
            "library_ms": median_ms(library, 20),
            "library_device_ms": device_ms(library, 20),
            "library_fill_ms": median_ms(library_fill, 20),
            "library_fill_device_ms": device_ms(library_fill, 20),
            "bytes": fold_bytes, "bound_ms": bound_ms(fold_bytes)}
        if key != "fold2":
            fold_rows[key]["shape"]["bfs_superstep"] = fold_iter
        say("kernels", name="segment_fold", **fold_rows[key])
    del ev, ids2, vals, masked, ids64, lib_acc
    report["segment_fold"] = {"max_abs_err": fold_err,
                              "by_stream": fold_rows}

    # The composed DC path's kernels, at the shapes of its PageRank step:
    # every partition in DC mode, every source live.  dc_gather is checked
    # in both of its regimes (staged on the pieces ScatterKernel binds, L2
    # without them) and timed through ScatterKernel, the engine's path.
    k, q = L.k, L.q
    nm = L.num_msgs
    sk = ScatterKernel(L, "add", torch.float32, dev)
    check(sk.pieces is not None, "the layout's slot tiles gave no pieces")
    scat = (sk.png_src_local, sk.png_valid, sk.png_tile_part)
    geo = dict(k=k, q=q, msg_tile=L.msg_tile)

    def regime_of(fn, kernel=_build.DC_GATHER):
        """The regime of ``kernel`` (dc_gather or its lane form) that one
        call of ``fn`` launched."""
        regimes = kernel.regimes
        before = dict(regimes)
        fn()
        moved = [r for r in regimes if regimes[r] != before[r]]
        check(len(moved) == 1, f"{kernel.name} regimes moved: {moved}")
        return moved[0]

    gather_err = 0.0
    for pieces, regime in ((sk.pieces, "staged"), (None, "l2")):
        for monoid in MONOIDS:
            for dname, dtype in dtypes.items():
                x = payload(n_pad, dtype).view(k, q)
                act = (torch.rand(n_pad, generator=gen, device=dev)
                       < 0.5).view(k, q)
                got = []
                check(regime_of(lambda: got.append(dc_gather(
                    x, act, *scat, monoid=monoid, pieces=pieces, **geo)))
                    == regime, f"dc_gather did not take its {regime} regime")
                gather_err = max(gather_err, max_abs_err(
                    (got[0],),
                    (ref_dc_gather(x, act, *scat, monoid=monoid, **geo),),
                    f"dc_gather {regime} {monoid} {dname}"))
    x_flat = payload(n_pad, torch.float32)
    live = torch.ones(n_pad, dtype=torch.bool, device=dev)
    half = torch.rand(n_pad, generator=gen, device=dev) < 0.5
    x, act = x_flat.view(k, q), live.view(k, q)
    # the yardstick: a gather of x over the slots' global sources (pads
    # name their tile's partition's vertex 0), without the select
    png_src = (sk.png_tile_part.repeat_interleave(L.msg_tile) * q
               + sk.png_src_local)
    bins = torch.empty(nm, device=dev)

    def gather_times(fn):
        return {"regime": regime_of(fn), **kernel_times(fn, 20)}

    gather_bytes = nm * (4 + 1 + 4) + (nm // L.msg_tile) * 4 + n_pad * (4 + 1)
    report["dc_gather"] = {
        "shape": {"slots": nm, "slot_tiles": nm // L.msg_tile, "k": k,
                  "q": q, "pieces": int(sk.pieces.numel() - 1)},
        "case": "add float32, all sources live, through ScatterKernel",
        "max_abs_err": gather_err, **gather_times(lambda: sk(x_flat, live)),
        "plain_ms": median_ms(lambda: ref_dc_gather(x, act, *scat, **geo),
                              3),
        # one PyTorch call of the same gather, without the select
        "library_ms": median_ms(
            lambda: torch.index_select(x_flat, 0, png_src), 20),
        "bytes": gather_bytes,
        "bound_ms": bound_ms(gather_bytes),
        "controls": {
            "staged_half_active": gather_times(lambda: sk(x_flat, half)),
            "l2": gather_times(lambda: dc_gather(x, act, *scat, **geo)),
            "l2_half_active": gather_times(lambda: dc_gather(
                x, half.view(k, q), *scat, **geo)),
            "index_select": {"regime": None, **kernel_times(
                lambda: torch.index_select(x_flat, 0, png_src), 20)},
            # the card's rate on a plain stream of this size: png_src_local
            # copied into a bins-sized buffer (8 B a slot of the kernel's 9)
            "stream_copy": {"regime": None, **kernel_times(
                lambda: bins.copy_(sk.png_src_local.view(torch.float32)),
                20)}}}
    say("kernels", name="dc_gather", **report["dc_gather"])
    del png_src, half, bins

    gk = GatherKernel(L, "add", torch.float32, dev)
    geo = dict(k=k, q=q, edge_tile=L.edge_tile)
    # the ring, and plain loads on arrays off a 16-byte boundary
    combine_paths = {"ring": lambda a: a, "plain_loads": unaligned}
    combine_err = 0.0
    for path, view in combine_paths.items():
        for monoid in MONOIDS:
            for dname, dtype in dtypes.items():
                vals = payload(ne, dtype)
                valid = edge_valid & (torch.rand(ne, generator=gen,
                                                 device=dev) < 0.7)
                part_active = torch.rand(k, generator=gen, device=dev) < 0.5
                cargs = (view(vals), view(valid), view(gk.edge_dst_local),
                         gk.tile_dst_part, gk.tile_src_part, gk.tile_first,
                         part_active)
                combine_err = max(combine_err, max_abs_err(
                    segment_combine(*cargs, monoid=monoid,
                                    part_tile_off=gk.part_tile_off, **geo),
                    ref_segment_combine(*cargs, monoid=monoid, **geo),
                    f"segment_combine {path} {monoid} {dname}"))
    all_parts = torch.ones(k, dtype=torch.bool, device=dev)
    combine_vals = {"float32": payload(ne, torch.float32),
                    "int32": payload(ne, torch.int32)}
    vals = combine_vals["float32"]

    def combine_call(monoid="add", dname="float32", view=lambda a: a):
        args = (view(combine_vals[dname]), view(edge_valid),
                view(gk.edge_dst_local), gk.tile_dst_part, gk.tile_src_part,
                gk.tile_first, all_parts)
        return lambda: segment_combine(*args, monoid=monoid,
                                       part_tile_off=gk.part_tile_off, **geo)

    edge_dst64 = edge_dst.to(torch.int64)
    lib_vals = torch.where(edge_valid, vals, 0.0)
    lib_acc = torch.zeros(ns, device=dev)
    combine_bytes = ne * (4 + 1 + 4) + nt * 4 + (k + 1) * 8 + k \
        + n_pad * (4 + 1)
    report["segment_combine"] = {
        "shape": {"edges": ne, "edge_tiles": nt, "k": k, "q": q},
        "case": "add float32, every source partition active",
        "max_abs_err": combine_err,
        **kernel_times(combine_call(), 20),
        "plain_ms": median_ms(lambda: ref_segment_combine(
            vals, edge_valid, gk.edge_dst_local, gk.tile_dst_part,
            gk.tile_src_part, gk.tile_first, all_parts, **geo), 3),
        "library_ms": median_ms(lambda: lib_acc.scatter_reduce_(
            0, edge_dst64, lib_vals, "sum", include_self=True), 20),
        "bytes": combine_bytes, "bound_ms": bound_ms(combine_bytes),
        "controls": {
            "i32_add": kernel_times(combine_call(dname="int32"), 20),
            "f32_min": kernel_times(combine_call("min"), 20),
            "f32_add_plain_loads": kernel_times(
                combine_call(view=unaligned), 20)}}
    say("kernels", name="segment_combine", **report["segment_combine"])
    del lib_vals, lib_acc, combine_vals

    vk = SpmvKernel(L, dev)
    spmv_args = (vk.edge_src_local, vk.edge_dst_local, vk.edge_valid)
    spmv_tiles = (vk.tile_dst_part, vk.tile_src_part, vk.tile_first)
    w_int = payload(ne, torch.float32)       # integer weights: exact sums
    spmv_err = 0.0
    for weighted in (False, True):
        x = payload(n_pad, torch.float32).view(k, q)
        spmv_err = max(spmv_err, max_abs_err(
            (spmv_block(x, *spmv_args, w_int, *spmv_tiles, weighted=weighted,
                        part_tile_off=vk.part_tile_off, **geo),),
            (ref_spmv_block(x, *spmv_args, w_int, *spmv_tiles,
                            weighted=weighted, **geo),),
            f"spmv_block weighted={weighted}"))
    del w_int
    # timed on the layout's own weights, as the tuner's row runs it
    x = torch.rand((k, q), generator=gen, device=dev)
    rows = {}
    for weighted in (True, False):
        w = vk.edge_w if weighted else None
        spmv_bytes = ne * (4 + 4 + 1 + (4 if weighted else 0)) + nt * 4 \
            + (k + 1) * 8 + 2 * n_pad * 4
        rows[weighted] = {
            **kernel_times(lambda: spmv_block(
                x, *spmv_args, w, *spmv_tiles, weighted=weighted,
                part_tile_off=vk.part_tile_off, **geo), 20),
            "plain_ms": median_ms(lambda: ref_spmv_block(
                x, *spmv_args, w, *spmv_tiles, weighted=weighted, **geo), 3),
            "bytes": spmv_bytes, "bound_ms": bound_ms(spmv_bytes)}
    # the yardstick: A^T (weighted) as a CSR matrix times x, built untimed
    valid_np = L.edge_valid.astype(bool)
    src_np = (np.repeat(L.tile_src_part.astype(np.int64), L.edge_tile) * q
              + L.edge_src_local)[valid_np]
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([L.edge_dst[valid_np].astype(np.int64),
                                       src_np])),
            torch.from_numpy(L.edge_w[valid_np]), (n_pad, n_pad)).to(dev)
        at_csr = coo.coalesce().to_sparse_csr()
    del coo, src_np, valid_np
    xv = x.reshape(-1, 1)
    rows[True]["library_ms"] = median_ms(lambda: at_csr @ xv, 20)
    rows[True]["library_device_ms"] = device_ms(lambda: at_csr @ xv, 20)
    rows[False]["library_ms"] = None
    del at_csr
    report["spmv_block"] = {
        "shape": {"edges": ne, "edge_tiles": nt, "k": k, "q": q},
        "max_abs_err": spmv_err, "weighted": rows[True],
        "unweighted": rows[False]}
    say("kernels", name="spmv_block", **report["spmv_block"])

    # PageRank's composed DC step, whole and by part, against the fused one
    os.environ[ENV_FUSED] = "0"
    pr_eng = rt.Engine(L, rt.apps.pagerank_program(g.n), mode="dc")
    del os.environ[ENV_FUSED]
    check(not pr_eng.fused, "REPRO_FUSED=0 did not select the composed path")
    msgs = payload(n_pad, torch.float32)
    live = torch.ones(n_pad, dtype=torch.bool, device=dev)
    bins = pr_eng._scatter(msgs, live)
    bins_p = torch.cat([bins, torch.zeros(1, device=dev)])
    valid_p = torch.ones(nm + 1, dtype=torch.bool, device=dev)
    report["composed_dc_step"] = {
        "case": "PageRank: add float32, every partition DC, all live",
        "step_ms": median_ms(lambda: pr_eng.composed_dc(
            msgs, live, all_parts), 10),
        "dc_gather_ms": median_ms(lambda: pr_eng._scatter(msgs, live), 10),
        "slot_gather_ms": median_ms(lambda: (
            torch.index_select(bins_p, 0, pr_eng.msg_slot),
            torch.index_select(valid_p, 0, pr_eng.msg_slot)), 10),
        "slot_gather_bytes": ne * (4 + 4 + 1) + (nm + 1) * (4 + 1),
        "segment_combine_ms": median_ms(lambda: pr_eng._gather(
            vals, edge_valid, all_parts), 10),
        "fused_dc_ms": fused_ms}
    report["composed_dc_step"]["slot_gather_bound_ms"] = bound_ms(
        report["composed_dc_step"]["slot_gather_bytes"])
    say("kernels", name="composed_dc_step", **report["composed_dc_step"])
    del pr_eng, bins, bins_p, valid_p, vk

    # ---------------- lanes ----------------
    # The lane forms of the batched engine's DC kernels (one launch for B
    # queries, lane b on blockIdx.y): each against its plain lane version,
    # bit-exact, at B = 4 (every monoid x dtype) and B = 16 (a few), on both
    # of its paths; then timed at B = 16 at PageRank's and SSSP's shapes,
    # beside its bound (the lanes' shared stream once, their own bytes B
    # times) and a yardstick: B single-lane launches on the same lanes.
    lanes = 16
    idx, _ = global_edges(
        kern.tile_src_part, kern.tile_dst_part, kern.edge_src_local,
        kern.edge_dst_local, edge_valid, q=L.q, edge_tile=L.edge_tile,
        n_pad=n_pad)
    all_cases = [(m, d) for m in MONOIDS for d in dtypes]
    few_cases = [("add", "float32"), ("max", "int32")]

    def lane_payload(b, n, dtype):
        return payload(b * n, dtype).view(b, n)

    def lane_unaligned(t):
        return unaligned(t.reshape(-1)).view(t.shape)

    # fused_dc's lane form reads its own copy of the edges (one a path:
    # the layout's arrays, and copies off a 16-byte boundary)
    fused_lane_paths = {
        "ring": (tiles, edge_valid, kern.edge_w),
        "plain_loads": (
            EdgeTiles(unaligned(tiles.edge_src_local),
                      unaligned(tiles.edge_dst_local), *tiles[2:]),
            unaligned(edge_valid), unaligned(kern.edge_w))}
    lane_copies = {path: build_lane_edges(tl, ev, w)
                   for path, (tl, ev, w) in fused_lane_paths.items()}
    lane_err = dict.fromkeys(("fused_dc", "fused_dc_interleave",
                              "segment_combine", "dc_gather"), 0.0)
    for b, cases in ((4, all_cases), (lanes, few_cases)):
        for path, (tl, ev, w) in fused_lane_paths.items():
            for monoid, dname, fn in ([(m, d, None) for m, d in cases]
                                      + [("min", "float32", add_weight)]):
                dtype = dtypes[dname]
                table = lane_payload(b, ns, dtype)
                tvalid = torch.rand((b, ns), generator=gen, device=dev) < 0.5
                tvalid[0] = False
                got = fused_scatter_fold(
                    table, tvalid, None, ev, None, ns, monoid=monoid,
                    tiles=tl, apply_weight=fn, w=w if fn else None,
                    lane_edges=lane_copies[path])
                want = ref_fused_scatter_fold(
                    M.REGISTRY[monoid](dtype), table, tvalid, idx, edge_valid,
                    edge_dst, ns, apply_weight=fn,
                    w=kern.edge_w if fn else None)
                lane_err["fused_dc"] = max(lane_err["fused_dc"], max_abs_err(
                    got, want, f"fused_dc[lanes={b}] {path} {monoid} {dname}"
                    + (" add_weight" if fn else "")))
                del got, want
    combine_lane_paths = {"ring": lambda a: a, "plain_loads": lane_unaligned}
    geo = dict(k=k, q=q, edge_tile=L.edge_tile)
    for b, cases in ((4, all_cases), (lanes, few_cases)):
        for path, view in combine_lane_paths.items():
            for monoid, dname in cases:
                vals = lane_payload(b, ne, dtypes[dname])
                valid = edge_valid & (torch.rand((b, ne), generator=gen,
                                                 device=dev) < 0.7)
                part_active = torch.rand((b, k), generator=gen,
                                         device=dev) < 0.5
                part_active[0] = False
                cargs = (view(vals), view(valid), gk.edge_dst_local,
                         gk.tile_dst_part, gk.tile_src_part, gk.tile_first,
                         part_active)
                lane_err["segment_combine"] = max(
                    lane_err["segment_combine"], max_abs_err(
                        segment_combine(*cargs, monoid=monoid,
                                        part_tile_off=gk.part_tile_off, **geo),
                        ref_segment_combine(*cargs, monoid=monoid, **geo),
                        f"segment_combine[lanes={b}] {path} {monoid} "
                        f"{dname}"))
                del vals, valid, cargs
    geo_g = dict(k=k, q=q, msg_tile=L.msg_tile)
    for b, cases in ((4, all_cases), (lanes, few_cases)):
        for pieces, regime in ((sk.pieces, "staged"), (None, "l2")):
            for monoid, dname in cases:
                x = lane_payload(b, n_pad, dtypes[dname]).view(b, k, q)
                act = (torch.rand((b, n_pad), generator=gen, device=dev)
                       < 0.5).view(b, k, q)
                act[0] = False
                got = []
                check(regime_of(lambda: got.append(dc_gather(
                    x, act, *scat, monoid=monoid, pieces=pieces, **geo_g)),
                    _build.DC_GATHER_LANES) == regime,
                    f"dc_gather[lanes={b}] did not take its {regime} regime")
                lane_err["dc_gather"] = max(lane_err["dc_gather"], max_abs_err(
                    (got[0],),
                    (ref_dc_gather(x, act, *scat, monoid=monoid, **geo_g),),
                    f"dc_gather[lanes={b}] {regime} {monoid} {dname}"))
                del got, x, act

    def singles(call, *batched):
        """The yardstick: ``call`` once per lane, on each lane's rows."""
        rows = [[t[i] for t in batched] for i in range(lanes)]
        return lambda: [call(*r) for r in rows]

    # fused_dc: PageRank's step (f32 add, every source live) and SSSP's
    # (f32 min, add_weight); the edges are every lane's.  The lane form's
    # edge copy is built here as an engine builds it at its first lane
    # launch (timed, with its bytes), and its two launches are also timed
    # each alone, on buffers allocated once.
    ltab = lane_payload(lanes, ns, torch.float32)
    lvalid = torch.ones((lanes, ns), dtype=torch.bool, device=dev)
    del lane_copies
    torch.cuda.synchronize()
    t = time.perf_counter()
    lane_le = build_lane_edges(tiles, edge_valid, kern.edge_w)
    torch.cuda.synchronize()
    lane_edges_rec = {"edges": lane_le.src.numel(), "fine": lane_le.fine,
                      "bytes": lane_le.nbytes(),
                      "build_s": time.perf_counter() - t}

    # a control: the same copy with the table's rows in vertex order, not
    # ranked by use
    by_row = torch.empty_like(lane_le.rank)
    by_row[lane_le.rank.long()] = torch.arange(ns, dtype=torch.int32,
                                               device=dev)
    unranked_le = lane_le._replace(src=by_row[lane_le.src.long()],
                                   rank=torch.arange(ns, dtype=torch.int32,
                                                     device=dev))
    del by_row

    def fused_one(monoid="add", fn=None, le=lane_le):
        w = kern.edge_w if fn else None
        return lambda t, v: fused_scatter_fold(
            t, v, None, edge_valid, None, ns, monoid=monoid, tiles=tiles,
            apply_weight=fn, w=w, lane_edges=le)

    def lane_parts(table, tvalid, monoid="add", fn=None):
        """The lane form's two launches, each alone on buffers allocated
        once: (interleave, fold, the interleaved table and mask)."""
        b, m = table.shape
        size, group = table.element_size(), lane_group(b)
        il = torch.empty((m, b), dtype=table.dtype, device=dev)
        mk = torch.empty((m, -(-b // 32)), dtype=torch.int32, device=dev)
        acc = torch.empty((b, ns), dtype=table.dtype, device=dev)
        tch = torch.empty((b, ns), dtype=torch.bool, device=dev)
        codes = (_build.MONOID_CODES[monoid],
                 _build.dtype_code(table.dtype, monoid),
                 fused_step._EDGE_FNS[fn])
        stream = _build.stream_handle(dev)
        le = lane_le

        def interleave():
            _build.FUSED_DC_INTERLEAVE.launch(
                table.data_ptr(), tvalid.data_ptr(), m, m, b, size,
                le.rank.data_ptr(), il.data_ptr(), mk.data_ptr(), stream)

        def fold():
            _build.FUSED_DC_LANES.launch(
                il.data_ptr(), mk.data_ptr(), m, b, le.src.data_ptr(),
                le.dst.data_ptr(), le.w.data_ptr() if fn else None,
                le.off.data_ptr(), k, q, le.fine,
                lane_width(group, size, q, le.fine), group, ns, ns, *codes,
                acc.data_ptr(), tch.data_ptr(), stream)
        return interleave, fold, (il, mk)

    def fused_lane_bytes(weighted, size=4, b=lanes):
        """What the lane form must move: the edge copy's source rows and
        local destinations (and weights) and its offsets, once for every
        lane, and each lane's table, validity, acc and touched."""
        return (lane_le.src.numel() * (4 + 4 + (4 if weighted else 0))
                + lane_le.off.numel() * 8 + b * ns * (size + 1 + size + 1))

    def interleave_bytes(size):
        return lanes * ns * (size + 1) + ns * lanes * size + ns * 4

    def interleave_library(table):
        """The interleave's yardstick: index_select of the lane table's
        transpose by the row order (entry v at row rank[v]; no masks)."""
        order = torch.empty(ns, dtype=torch.int64, device=dev)
        order[lane_le.rank.long()] = torch.arange(ns, device=dev)
        return median_ms(lambda: torch.index_select(table.t(), 0, order), 10)

    def lane_fold_library(table, valid):
        """The lane fold's yardstick, as the [flat] rows': index_add_ of
        every lane's values gathered beforehand (untimed) into [B * ns]."""
        b = table.shape[0]
        vals = torch.where(edge_valid.to(torch.bool) & valid[:, idx.long()],
                           table[:, idx.long()], 0.0).reshape(-1)
        ids = (torch.arange(b, device=dev)[:, None] * ns
               + edge_dst.to(torch.int64)).reshape(-1)
        acc = torch.zeros(b * ns, dtype=table.dtype, device=dev)
        return median_ms(lambda: acc.index_add_(0, ids, vals), 10)

    interleave, lane_fold, il_out = lane_parts(ltab, lvalid)
    interleave()
    lane_err["fused_dc_interleave"] = max_abs_err(
        il_out, ref_interleave_lanes(ltab, lvalid, lane_le.rank),
        "fused_dc_interleave[lanes=16]")
    report["fused_dc_interleave"] = {
        "lanes": lanes, "shape": {"table": [lanes, ns]},
        "case": "float32, every source live (PageRank's step)",
        **kernel_times(interleave, 10),
        "plain_ms": median_ms(lambda: ref_interleave_lanes(
            ltab, lvalid, lane_le.rank), 2),
        "library_ms": interleave_library(ltab), "bytes": interleave_bytes(4),
        "bound_ms": bound_ms(interleave_bytes(4)),
        "max_abs_err": lane_err["fused_dc_interleave"]}
    say("kernels", name="fused_dc_interleave[lanes=16]",
        **report["fused_dc_interleave"])
    report["fused_dc_lanes"] = {
        "lanes": lanes, "shape": {"table": [lanes, ns], "edges": ne,
                                  "group": lane_group(lanes),
                                  "width": lane_width(lane_group(lanes), 4,
                                                      q)},
        "case": "add float32, all sources live (PageRank's step)",
        **kernel_times(lambda: fused_one()(ltab, lvalid), 10),
        "plain_ms": median_ms(lambda: ref_fused_scatter_fold(
            M.add(torch.float32), ltab, lvalid, idx, edge_valid, edge_dst,
            ns), 2),
        "bytes": fused_lane_bytes(False),
        "bound_ms": bound_ms(fused_lane_bytes(False)),
        "max_abs_err": lane_err["fused_dc"],
        "library_ms": lane_fold_library(ltab, lvalid),
        "lane_edges": lane_edges_rec,
        "controls": {
            "fold_only": kernel_times(lane_fold, 10),
            "unranked_rows": kernel_times(
                lambda: fused_one(le=unranked_le)(ltab, lvalid), 10),
            "single_lane_x16": kernel_times(
                singles(fused_one(), ltab, lvalid), 10),
            "sssp_f32_min_add_weight": dict(
                kernel_times(lambda: fused_one("min", add_weight)(
                    ltab, lvalid), 10),
                bound_ms=bound_ms(fused_lane_bytes(True))),
            "sssp_single_lane_x16": kernel_times(
                singles(fused_one("min", add_weight), ltab, lvalid), 10)}}
    say("kernels", name="fused_dc[lanes=16]", **report["fused_dc_lanes"])
    del ltab, lvalid, idx, il_out, interleave, lane_fold

    # segment_combine: the composed PageRank step's stream in every lane
    # (f32 add, every source partition active), and f32 min
    lvals = lane_payload(lanes, ne, torch.float32)
    lvalid = edge_valid.expand(lanes, ne).contiguous()
    lparts = torch.ones((lanes, k), dtype=torch.bool, device=dev)

    def combine_one(monoid="add"):
        return lambda v, e, pa: segment_combine(
            v, e, gk.edge_dst_local, gk.tile_dst_part, gk.tile_src_part,
            gk.tile_first, pa, monoid=monoid,
            part_tile_off=gk.part_tile_off, **geo)

    combine_lane_bytes = (ne * 4 + nt * 4 + (k + 1) * 8
                          + lanes * (ne * (4 + 1) + k + n_pad * (4 + 1)))
    # the library call: one scatter_reduce_ over the lanes' flattened
    # lane * ns + dst segment space
    lib_ids = (torch.arange(lanes, device=dev)[:, None] * ns
               + edge_dst64).reshape(-1)
    lib_vals = torch.where(lvalid, lvals, 0.0).reshape(-1)
    lib_acc = torch.zeros(lanes * ns, device=dev)
    report["segment_combine_lanes"] = {
        "lanes": lanes, "shape": {"vals": [lanes, ne], "k": k, "q": q},
        "case": "add float32, every source partition active",
        **kernel_times(lambda: combine_one()(lvals, lvalid, lparts), 10),
        "plain_ms": median_ms(lambda: ref_segment_combine(
            lvals, lvalid, gk.edge_dst_local, gk.tile_dst_part,
            gk.tile_src_part, gk.tile_first, lparts, **geo), 2),
        "library_ms": median_ms(lambda: lib_acc.scatter_reduce_(
            0, lib_ids, lib_vals, "sum", include_self=True), 10),
        "bytes": combine_lane_bytes,
        "bound_ms": bound_ms(combine_lane_bytes),
        "max_abs_err": lane_err["segment_combine"],
        "controls": {
            "single_lane_x16": kernel_times(
                singles(combine_one(), lvals, lvalid, lparts), 10),
            "f32_min": kernel_times(
                lambda: combine_one("min")(lvals, lvalid, lparts), 10)}}
    say("kernels", name="segment_combine[lanes=16]",
        **report["segment_combine_lanes"])
    del lvals, lvalid, lparts, lib_ids, lib_vals, lib_acc

    # dc_gather: the composed PageRank step's scatter in every lane, through
    # ScatterKernel (staged), beside the L2 regime and half the sources
    lx = lane_payload(lanes, n_pad, torch.float32)
    png_src = (sk.png_tile_part.repeat_interleave(L.msg_tile) * q
               + sk.png_src_local)
    llive = torch.ones((lanes, n_pad), dtype=torch.bool, device=dev)
    lhalf = torch.rand((lanes, n_pad), generator=gen, device=dev) < 0.5

    def lane_gather_times(fn):
        return {"regime": regime_of(fn, _build.DC_GATHER_LANES),
                **kernel_times(fn, 10)}

    gather_lane_bytes = (nm * (4 + 1) + (nm // L.msg_tile) * 4
                         + lanes * (n_pad * (4 + 1) + nm * 4))
    report["dc_gather_lanes"] = {
        "lanes": lanes, "shape": {"x": [lanes, n_pad], "slots": nm},
        "case": "add float32, all sources live, through ScatterKernel",
        **lane_gather_times(lambda: sk(lx, llive)),
        "plain_ms": median_ms(lambda: ref_dc_gather(
            lx.view(lanes, k, q), llive.view(lanes, k, q), *scat, **geo_g),
            2),
        "library_ms": median_ms(
            lambda: torch.index_select(lx, -1, png_src), 10),
        "bytes": gather_lane_bytes,
        "bound_ms": bound_ms(gather_lane_bytes),
        "max_abs_err": lane_err["dc_gather"],
        "controls": {
            "single_lane_x16": {"regime": "staged", **kernel_times(
                singles(sk, lx, llive), 10)},
            "staged_half_active": lane_gather_times(lambda: sk(lx, lhalf)),
            "l2": lane_gather_times(lambda: dc_gather(
                lx.view(lanes, k, q), llive.view(lanes, k, q), *scat,
                **geo_g))}}
    say("kernels", name="dc_gather[lanes=16]", **report["dc_gather_lanes"])
    del png_src
    # ---------------- kernels: the 8-byte min ----------------
    # The int64 min of min_with_payload (SSSP with parents, seeded BFS) in
    # every kernel of its path, at the main path's shapes, on real packed
    # payloads: random non-negative f32 keys, a tenth +inf, any uint32
    # payload.  Integer min is exact in any order, so each form is
    # bit-exact with its plain version.  Each is timed four ways beside its
    # 8-byte bytes bound and the yardstick scatter_reduce_(amin) of the
    # same words into the same segments (for dc_gather, which folds
    # nothing, index_select of x over the slots' sources).
    wide = {}
    W = "min_with_payload"
    wmono = M.min_with_payload()

    def packed(n, shape=None):
        keys = torch.rand(n, generator=gen, device=dev) * 1000
        keys[torch.rand(n, generator=gen, device=dev) < 0.1] = float("inf")
        pay = torch.randint(0, 2**32, (n,), generator=gen, device=dev)
        words = (keys.view(torch.int32).to(torch.int64) << 32) | pay
        return words if shape is None else words.view(shape)

    def yardstick(vals, ok, ids, segments):
        """scatter_reduce_(amin) of ``vals`` (identity where not ``ok``)
        into ``segments`` int64 accumulators at ``ids``; built when its row
        is timed, and freed before the plain version runs."""
        masked = torch.where(ok, vals, wmono.identity).reshape(-1)
        ids64 = ids.to(torch.int64).reshape(-1)
        acc = torch.full((segments,), wmono.identity, dtype=torch.int64,
                         device=dev)
        return lambda: acc.scatter_reduce_(0, ids64, masked, "amin",
                                           include_self=True)

    def wide_row(name, fn, plain, nbytes, err, library, plain_reps=3,
                 reps=10, **extra):
        rec = {"case": "min_with_payload int64", **kernel_times(fn, reps)}
        if library is not None:    # a factory: its inputs are large
            call_library = library()
            rec["library_ms"] = median_ms(call_library, reps)
            del call_library
        else:
            rec["library_ms"] = None
        rec.update(plain_ms=median_ms(plain, plain_reps), bytes=nbytes,
                   bound_ms=bound_ms(nbytes), max_abs_err=err, **extra)
        wide[name] = rec
        say("kernels", name=name, **rec)

    # segment_fold: the SC stream into n_pad + 1 and into 4096 segments
    sc_valid = torch.rand(be, generator=gen, device=dev) < 0.9
    for key, fold_ns, ids in (("n_pad_plus_1", ns, dst),
                              ("ids_mod_4096", 4096, dst % 4096)):
        vals = packed(be)
        err = max_abs_err(
            blocked_segment_fold(vals, sc_valid, ids, fold_ns, monoid=W),
            segment_fold(vals, sc_valid, ids, fold_ns, W),
            f"segment_fold int64 ns={fold_ns}")
        masked = torch.where(sc_valid, vals, wmono.identity)
        ids64, ok8 = ids.to(torch.int64), sc_valid.to(torch.uint8)

        def library_fill():
            # the kernel's whole work in PyTorch calls: a fresh accumulator,
            # the fold, and the touched flags
            acc = torch.full((fold_ns,), wmono.identity, dtype=torch.int64,
                             device=dev).scatter_reduce_(
                0, ids64, masked, "amin", include_self=True)
            return acc, torch.zeros(fold_ns, dtype=torch.uint8,
                                    device=dev).scatter_reduce_(
                0, ids64, ok8, "amax", include_self=True)

        wide_row(f"segment_fold[int64] {key}", lambda: blocked_segment_fold(
                     vals, sc_valid, ids, fold_ns, monoid=W),
                 lambda: segment_fold(vals, sc_valid, ids, fold_ns, W),
                 be * (8 + 1 + 4) + fold_ns * (8 + 1), err,
                 lambda: yardstick(vals, sc_valid, ids, fold_ns),
                 shape={"messages": be, "num_segments": fold_ns},
                 library_fill_ms=median_ms(library_fill, 10),
                 library_fill_device_ms=device_ms(library_fill, 10))
        del masked, ids64, ok8

    # fused_dc and its lane form: both edge functions, both paths
    idx, _ = global_edges(
        kern.tile_src_part, kern.tile_dst_part, kern.edge_src_local,
        kern.edge_dst_local, edge_valid, q=L.q, edge_tile=L.edge_tile,
        n_pad=n_pad)
    wpaths = {"ring": (tiles, edge_valid, kern.edge_w),
              "plain_loads": (
                  EdgeTiles(unaligned(tiles.edge_src_local),
                            unaligned(tiles.edge_dst_local), *tiles[2:]),
                  unaligned(edge_valid), unaligned(kern.edge_w))}
    wcopies = {"ring": lane_le,
               "plain_loads": build_lane_edges(*wpaths["plain_loads"])}
    fused_wide_err = dict.fromkeys((1, 4, lanes), 0.0)
    for b in fused_wide_err:
        shape = (ns,) if b == 1 else (b, ns)
        for path, (tl, ev, w) in wpaths.items():
            for fn in (None, add_weight_to_key):
                table = packed(int(np.prod(shape)), shape)
                tvalid = torch.rand(shape, generator=gen, device=dev) < 0.5
                got = fused_scatter_fold(table, tvalid, None, ev, None, ns,
                                         monoid=W, tiles=tl,
                                         apply_weight=fn,
                                         w=w if fn else None,
                                         lane_edges=wcopies[path])
                want = ref_fused_scatter_fold(
                    wmono, table, tvalid, idx, edge_valid, edge_dst, ns,
                    apply_weight=fn, w=kern.edge_w if fn else None)
                fused_wide_err[b] = max(fused_wide_err[b], max_abs_err(
                    got, want, f"fused_dc[int64, lanes={b}] {path}"
                    + (" add_weight_to_key" if fn else "")))
                del got, want, table, tvalid
    del wpaths, wcopies

    def fused_wide(b, fn):
        shape = (ns,) if b == 1 else (b, ns)
        table = packed(int(np.prod(shape)), shape)
        live = torch.ones(shape, dtype=torch.bool, device=dev)
        w = kern.edge_w if fn else None
        call = lambda: fused_scatter_fold(
            table, live, None, edge_valid, None, ns, monoid=W, tiles=tiles,
            apply_weight=fn, w=w, lane_edges=lane_le)
        plain = lambda: ref_fused_scatter_fold(
            wmono, table, live, idx, edge_valid, edge_dst, ns,
            apply_weight=fn, w=w)
        def lib():
            # the yardstick folds the words the kernel folds, gathered and
            # weighted beforehand (untimed)
            words = table.index_select(-1, idx.to(torch.int64))
            if fn is not None:
                words = fn(words, kern.edge_w)
            lane = torch.arange(b, device=dev)[:, None] * ns
            ids = (lane + edge_dst.to(torch.int64)) if b > 1 else edge_dst
            return yardstick(words, edge_valid, ids, b * ns)

        nbytes = (fused_lane_bytes(fn is not None, 8, b) if b > 1 else
                  ne * (4 + 4 + 1 + (4 if fn else 0)) + nt * 4 + (k + 1) * 8
                  + ns * (8 + 1 + 8 + 1))
        extra = {}
        if b > 1:   # the lane form's launches alone, and one lane a launch
            interleave, fold, il_out = lane_parts(table, live, W, fn)
            interleave()
            extra = dict(lane_edges=lane_edges_rec, controls={
                "interleave_only": dict(kernel_times(interleave, 10),
                                        bound_ms=bound_ms(
                                            interleave_bytes(8))),
                "fold_only": kernel_times(fold, 10),
                "unranked_rows": kernel_times(
                    lambda: fused_scatter_fold(
                        table, live, None, edge_valid, None, ns, monoid=W,
                        tiles=tiles, apply_weight=fn, w=w,
                        lane_edges=unranked_le), 10),
                "single_lane_x16": kernel_times(
                    singles(lambda t, v: fused_scatter_fold(
                        t, v, None, edge_valid, None, ns, monoid=W,
                        tiles=tiles, apply_weight=fn, w=w), table, live),
                    10)},
                interleave_err=max_abs_err(
                    il_out, ref_interleave_lanes(table, live, lane_le.rank),
                    f"fused_dc_interleave[int64,lanes={b}]"),
                interleave_plain_ms=median_ms(
                    lambda: ref_interleave_lanes(table, live, lane_le.rank),
                    2),
                interleave_library_ms=interleave_library(table))
            del interleave, fold, il_out
        return call, plain, nbytes, lib, extra

    for b, fn, name in ((1, add_weight_to_key, "fused_dc[int64]"),
                        (1, None, "fused_dc[int64] no edge function"),
                        (lanes, add_weight_to_key,
                         "fused_dc[int64,lanes=16]"),
                        (lanes, None,
                         "fused_dc[int64,lanes=16] no edge function")):
        call, plain, nbytes, lib, extra = fused_wide(b, fn)
        wide_row(name, call, plain, nbytes, fused_wide_err[b], lib,
                 plain_reps=2 if b > 1 else 3,
                 shape={"table": [b, ns] if b > 1 else ns, "edges": ne,
                        "chunk": 16384} if b == 1 else {
                     "table": [b, ns], "edges": ne,
                     "group": lane_group(b),
                     "width": lane_width(lane_group(b), 8, q)},
                 edge_function=fn.__name__ if fn else None, **extra)
        del call, plain, lib, extra
    del unranked_le

    # dc_gather (staged: two blocks a piece, each staging half of the
    # 8-byte rows; L2 without pieces) and its lane form, on the slot
    # arrays and on copies off their boundaries (one slot a thread)
    sk_w = ScatterKernel(L, W, torch.int64, dev)
    check(sk_w.pieces is not None, "no 8-byte pieces for the layout")
    gather_wide_err = dict.fromkeys((1, 4, lanes), 0.0)
    for b in gather_wide_err:
        lead = () if b == 1 else (b,)
        kern_g = _build.DC_GATHER if b == 1 else _build.DC_GATHER_LANES
        for pieces, regime, slots in (
                (sk_w.pieces, "staged", scat), (None, "l2", scat),
                (sk_w.pieces, "staged", (unaligned(scat[0]),
                                         unaligned(scat[1]), scat[2]))):
            x = packed(b * n_pad, lead + (k, q))
            act = (torch.rand(lead + (n_pad,), generator=gen, device=dev)
                   < 0.5).view(lead + (k, q))
            got = []
            check(regime_of(lambda: got.append(dc_gather(
                x, act, *slots, monoid=W, pieces=pieces, **geo_g)), kern_g)
                == regime, f"dc_gather[int64, lanes={b}] did not take "
                f"{regime}")
            gather_wide_err[b] = max(gather_wide_err[b], max_abs_err(
                (got[0],), (ref_dc_gather(x, act, *scat, monoid=W,
                                          **geo_g),),
                f"dc_gather[int64, lanes={b}] {regime}"))
            del got, x, act
    for b, name in ((1, "dc_gather[int64]"), (lanes,
                                               "dc_gather[int64,lanes=16]")):
        lead = () if b == 1 else (b,)
        xw = packed(b * n_pad, lead + (n_pad,))
        live = torch.ones(lead + (n_pad,), dtype=torch.bool, device=dev)
        png_src = (sk_w.png_tile_part.repeat_interleave(L.msg_tile) * q
                   + sk_w.png_src_local).to(torch.int64)
        nbytes = (nm * (4 + 1) + (nm // L.msg_tile) * 4
                  + b * (n_pad * (8 + 1) + nm * 8))
        kern_g = _build.DC_GATHER if b == 1 else _build.DC_GATHER_LANES
        l2 = lambda: dc_gather(xw.view(lead + (k, q)),
                               live.view(lead + (k, q)), *scat, monoid=W,
                               **geo_g)
        wide_row(name, lambda: sk_w(xw, live), lambda: ref_dc_gather(
                     xw.view(lead + (k, q)), live.view(lead + (k, q)), *scat,
                     monoid=W, **geo_g),
                 nbytes, gather_wide_err[b],
                 lambda: lambda: torch.index_select(xw, -1, png_src),
                 plain_reps=2 if b > 1 else 3,
                 regime=regime_of(lambda: sk_w(xw, live), kern_g),
                 shape={"x": list(lead) + [n_pad], "slots": nm,
                        "pieces": int(sk_w.pieces.numel() - 1)},
                 controls={
                     "index_select": kernel_times(
                         lambda: torch.index_select(xw, -1, png_src), 10),
                     "l2": {"regime": regime_of(l2, kern_g),
                            **kernel_times(l2, 10)}})
        del l2
        del xw, live, png_src
    del sk_w

    # segment_combine and its lane form, both paths
    combine_wide_err = dict.fromkeys((1, 4, lanes), 0.0)
    for b in combine_wide_err:
        lead = () if b == 1 else (b,)
        for path, view in (("ring", lambda a: a),
                           ("plain_loads", lane_unaligned)):
            vals = view(packed(b * ne, lead + (ne,)))
            valid = view(edge_valid & (torch.rand(
                lead + (ne,), generator=gen, device=dev) < 0.7))
            part_active = torch.rand(lead + (k,), generator=gen,
                                     device=dev) < 0.5
            cargs = (vals, valid, gk.edge_dst_local, gk.tile_dst_part,
                     gk.tile_src_part, gk.tile_first, part_active)
            combine_wide_err[b] = max(combine_wide_err[b], max_abs_err(
                segment_combine(*cargs, monoid=W,
                                part_tile_off=gk.part_tile_off, **geo),
                ref_segment_combine(*cargs, monoid=W, **geo),
                f"segment_combine[int64, lanes={b}] {path}"))
            del vals, valid, cargs
    for b, name in ((1, "segment_combine[int64]"),
                    (lanes, "segment_combine[int64,lanes=16]")):
        lead = () if b == 1 else (b,)
        vals = packed(b * ne, lead + (ne,))
        cvalid = edge_valid.expand(lead + (ne,)).contiguous()
        parts = torch.ones(lead + (k,), dtype=torch.bool, device=dev)
        cargs = (vals, cvalid, gk.edge_dst_local, gk.tile_dst_part,
                 gk.tile_src_part, gk.tile_first, parts)
        lane = torch.arange(b, device=dev)[:, None] * ns
        nbytes = (ne * 4 + nt * 4 + (k + 1) * 8
                  + b * (ne * (8 + 1) + k + n_pad * (8 + 1)))
        wide_row(name, lambda: segment_combine(
                     *cargs, monoid=W, part_tile_off=gk.part_tile_off, **geo),
                 lambda: ref_segment_combine(*cargs, monoid=W, **geo),
                 nbytes, combine_wide_err[b],
                 lambda: yardstick(vals, cvalid,
                                   lane + edge_dst64 if b > 1 else edge_dst64,
                                   b * ns),
                 plain_reps=2 if b > 1 else 3,
                 shape={"vals": list(lead) + [ne], "k": k, "q": q,
                        "chunk": 16384})
        del vals, cvalid, cargs
    report["wide"] = wide
    del idx

    del lx, llive, lhalf, gk, sk, kern, tiles, edge_valid, edge_dst, \
        edge_dst64, fused_lane_paths

    # ---------------- apps ----------------
    P = to_scipy(g)                                      # weighted
    apps = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def app_record(name, res, wall, launches0):
        stats = res.get("stats", [])
        apps[name] = {
            "wall_s": wall, "iterations": len(stats),
            "modes": [s.mode for s in stats],
            "iter_wall_s": [s.wall_s for s in stats],
            "dc_iter_wall_s": sum(s.wall_s for s in stats if s.mode == "dc"),
            "launches": {k.name: k.launches - launches0[k.name]
                         for k in _build.KERNELS}}
        say("apps", app=name, **apps[name])

    def counts():
        return {k.name: k.launches for k in _build.KERNELS}

    def run_apps(tag):
        """BFS, SSSP, CC and PageRank (``run_fused``, then ``run``) on the
        default device; returns their results and the launches they made,
        counted from 0."""
        calls = {"bfs": lambda: rt.bfs(L, src),
                 "sssp": lambda: rt.sssp(L, src),
                 "cc": lambda: rt.connected_components(S),
                 "pagerank": lambda: rt.pagerank(L, iters=10),
                 "pagerank_run": lambda: rt.pagerank(L, iters=10,
                                                     fused=False)}
        _build.reset_launch_counts()
        out = {}
        for name, fn in calls.items():
            c0 = counts()
            out[name], wall = timed(fn)
            app_record(name + tag, out[name], wall, c0)
        return out, counts()

    fused_res, launches = run_apps("")
    say("apps", path="fused", launches=launches)
    for name in ("fused_dc", "segment_fold"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the fused path's apps")
    bfs_res, sssp_res = fused_res["bfs"], fused_res["sssp"]
    cc_res, pr_res = fused_res["cc"], fused_res["pagerank"]
    check([s.sc_parts for s in bfs_res["stats"]] == [t[3] for t in sc_iters],
          "the timed fold's SC stream is not one the hybrid BFS run folded")

    # host oracles
    t = time.perf_counter()
    d = csg.shortest_path(P, method="D", unweighted=True, indices=src)
    want_level = np.where(np.isinf(d), -1, d).astype(np.int32)
    want_dist = csg.dijkstra(P, indices=src)
    fin = ~np.isinf(want_dist)
    ncc, comp = csg.connected_components(to_scipy(gs), directed=False)
    least = np.full(ncc, g.n, np.int64)
    np.minimum.at(least, comp, np.arange(g.n))
    want_label = least[comp]
    want_pr = np.full(g.n, 1.0 / g.n)
    PT = P1.T.tocsr()
    outdeg = g.out_degrees()
    for _ in range(10):
        want_pr = 0.15 / g.n + 0.85 * (PT @ np.where(
            outdeg > 0, want_pr / np.maximum(outdeg, 1), 0.0))
    oracle_s = time.perf_counter() - t

    def check_oracles(res, tag):
        bfs_r, sssp_r = res["bfs"], res["sssp"]
        check(np.array_equal(bfs_r["level"], want_level),
              f"bfs{tag} levels differ from scipy")
        lv, par = bfs_r["level"], bfs_r["parent"]
        reached = lv > 0
        check(bool(np.all(lv[par[reached]] == lv[reached] - 1)),
              f"bfs{tag} parents are not one level up")
        check(np.array_equal(np.isinf(sssp_r["dist"]), ~fin),
              f"sssp{tag} reaches other vertices than Dijkstra")
        rel = float(np.max(np.abs(sssp_r["dist"][fin] - want_dist[fin])
                           / np.maximum(want_dist[fin], 1e-30)))
        check(np.allclose(sssp_r["dist"][fin], want_dist[fin], rtol=1e-5,
                          atol=0), f"sssp{tag} differs from Dijkstra ({rel})")
        check(np.array_equal(res["cc"]["label"].astype(np.int64),
                             want_label),
              f"cc{tag} labels are not the least vertex id of each component")
        l1 = {}
        for name in ("pagerank", "pagerank_run"):
            l1[name] = float(np.abs(res[name]["pr"].astype(np.float64)
                                    - want_pr).sum())
            check(l1[name] <= 1e-5, f"{name}{tag} L1 distance {l1[name]} "
                  "> 1e-5")
        return {"bfs_levels_equal": True, "sssp_max_rel_err": rel,
                "cc_components": int(ncc), "pagerank_l1": l1["pagerank"],
                "pagerank_run_l1": l1["pagerank_run"]}

    report["oracles"] = dict(check_oracles(fused_res, ""),
                             oracle_s=oracle_s)
    say("apps", oracles=report["oracles"])

    # An engine's set-up is part of every app's wall time above.  Split on
    # each DC lowering, inside the one construction that is timed: the host
    # clock around each host-to-card copy (torch.Tensor.to from the CPU to
    # the card, with a synchronize after it so that the copy has landed),
    # around the per-tile host check of the tile kernels' precondition, and
    # around the fused kernel's per-edge check on the card, less the copy it
    # makes of the layout's edge_dst.  The rest is host array work and
    # Python.
    def engine_setup(fused: bool, name: str, make) -> dict:
        spent = {"host_tile_check_s": 0.0, "card_edge_check_s": 0.0,
                 "copies_s": 0.0, "copied_bytes": 0}
        to = torch.Tensor.to

        def timed_to(tensor, *a, **kw):
            if tensor.device.type != "cpu":
                return to(tensor, *a, **kw)
            start = time.perf_counter()
            out = to(tensor, *a, **kw)
            if out.is_cuda:
                torch.cuda.synchronize()
                spent["copies_s"] += time.perf_counter() - start
                spent["copied_bytes"] += tensor.numel() * tensor.element_size()
            return out

        def phase(fn, key):
            def run(*a, **kw):
                copies0, start = spent["copies_s"], time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spent[key] += (time.perf_counter() - start
                                   - (spent["copies_s"] - copies0))
            return run

        checks = {"_partition_tile_offsets": "host_tile_check_s",
                  "_check_edge_dst": "card_edge_check_s"}
        saved = {fn: getattr(ops, fn) for fn in checks}
        if not fused:
            os.environ[ENV_FUSED] = "0"
        torch.Tensor.to = timed_to
        for fn, key in checks.items():
            setattr(ops, fn, phase(saved[fn], key))
        try:
            eng, total = timed(make)
        finally:
            torch.Tensor.to = to
            for fn, f in saved.items():
                setattr(ops, fn, f)
            os.environ.pop(ENV_FUSED, None)
        check(eng.fused == fused, f"{name} engine took the wrong DC path")
        del eng
        return {"engine_setup_s": total, **spent,
                "rest_s": total - spent["host_tile_check_s"]
                - spent["card_edge_check_s"] - spent["copies_s"]}

    report["engine_setup"] = {
        f"{name}_{path}": engine_setup(path == "fused", name,
                                       lambda p=program: rt.Engine(L, p))
        for path in ("fused", "composed")
        for name, program in (("bfs", rt.apps.bfs_program()),
                              ("sssp", rt.apps.sssp_program()))}
    for key, rec in report["engine_setup"].items():
        say("apps", engine=key, **rec)

    plain, setup_s = timed(
        lambda: rt.Engine(L, rt.apps.bfs_program(), plain=True))
    say("apps", engine_setup_s=setup_s)
    plain_res, wall = timed(lambda: rt.bfs(L, src, engine=plain))
    check(np.array_equal(plain_res["level"], bfs_res["level"])
          and np.array_equal(plain_res["parent"], bfs_res["parent"]),
          "hybrid bfs through the plain versions differs from the kernels")
    say("apps", app="bfs_plain_versions", wall_s=wall, bit_exact=True)
    del plain

    # the composed DC path: engines built while REPRO_FUSED=0
    os.environ[ENV_FUSED] = "0"
    composed_res, composed_launches = run_apps("_composed")
    del os.environ[ENV_FUSED]
    say("apps", path="composed", launches=composed_launches)
    for name in ("dc_gather", "segment_combine"):
        check(composed_launches[name] > 0,
              f"kernel {name} was not launched by the composed path's apps")
    check(composed_launches["fused_dc"] == 0,
          "the composed path launched the fused DC kernel")
    report["dc_gather_regimes_composed"] = dict(_build.DC_GATHER.regimes)
    say("apps", path="composed",
        dc_gather_regimes=report["dc_gather_regimes_composed"])
    # (these apps fold 4-byte values)
    check(_build.DC_GATHER.regimes["staged"] == composed_launches["dc_gather"],
          "the composed apps' dc_gather launches were not all staged")
    report["oracles_composed"] = check_oracles(composed_res, " (composed)")
    for name, key in (("bfs", "level"), ("bfs", "parent"), ("sssp", "dist"),
                      ("cc", "label")):
        check(np.array_equal(composed_res[name][key], fused_res[name][key]),
              f"composed {name} {key} differs from the fused run")
    pr_diff = {}
    for name in ("pagerank", "pagerank_run"):
        pr_diff[name] = float(np.abs(
            composed_res[name]["pr"].astype(np.float64)
            - fused_res[name]["pr"]).sum())
        check(pr_diff[name] <= 1e-6,
              f"composed {name} is {pr_diff[name]} (L1) from the fused run")
    report["composed_vs_fused"] = {"bit_exact": ["bfs", "sssp", "cc"],
                                   "pagerank_l1": pr_diff}
    say("apps", composed_vs_fused=report["composed_vs_fused"])
    report["apps"] = apps
    report["engine_setup_s"] = setup_s
    del fused_res, composed_res

    # ---------------- baselines ----------------
    # the vertex-centric baselines (plain torch over the edge list, no
    # partitions) on the same graphs and sources, against the same oracles,
    # each wall beside the same app's GPOP wall from the fused run above
    from repro_torch.baselines import vc
    base = {}

    def baseline(name, fn, gpop_app, check_fn):
        out, wall = timed(fn)
        base[name] = {"wall_s": wall, "gpop_app": gpop_app,
                      "gpop_wall_s": apps[gpop_app]["wall_s"],
                      **check_fn(out)}
        say("baselines", name=name, **base[name])

    def levels_ok(what):
        def run(lv):
            check(np.array_equal(lv, want_level),
                  f"{what} levels differ from scipy")
            return {"levels_equal": True}
        return run

    def dist_ok(dist):
        check(np.array_equal(np.isinf(dist), ~fin),
              "sssp_push reaches other vertices than Dijkstra")
        rel = float(np.max(np.abs(dist[fin] - want_dist[fin])
                           / np.maximum(want_dist[fin], 1e-30)))
        check(rel <= 1e-5, f"sssp_push differs from Dijkstra ({rel})")
        return {"max_rel_err": rel}

    def labels_ok(label):
        check(np.array_equal(label.astype(np.int64), want_label),
              "cc_ec labels are not the least vertex id of each component")
        return {"components": int(ncc)}

    def pr_ok(pr):
        l1 = float(np.abs(pr.astype(np.float64) - want_pr).sum())
        check(l1 <= 1e-5, f"pagerank_spmv L1 distance {l1} > 1e-5")
        return {"l1": l1}

    c0 = counts()
    for name in ("bfs_push", "bfs_pull", "bfs_ec"):
        baseline(name, lambda f=getattr(vc, name): f(g, src), "bfs",
                 levels_ok(name))
    baseline("sssp_push", lambda: vc.sssp_push(g, src), "sssp", dist_ok)
    baseline("pagerank_spmv", lambda: vc.pagerank_spmv(g, iters=10),
             "pagerank", pr_ok)
    baseline("cc_ec", lambda: vc.cc_ec(gs), "cc", labels_ok)
    check(counts() == c0, "a baseline launched a GPOP kernel")
    report["baselines"] = base

    # ---------------- batched ----------------
    # bfs_multi and sssp_multi over 16 lanes (src, then 15 sources spread
    # over the vertex ids) on each DC lowering: every lane bit-exact with a
    # sequential run on the card, the src lane with the scipy oracles, and
    # each batched step one launch of each lane kernel of its lowering and
    # of no other kernel (counts set to 0 before each run, read after it).
    sources = np.concatenate(
        [[src], np.linspace(0, g.n - 1, lanes - 1).astype(np.int64)])
    t = time.perf_counter()
    seq_engines = {"bfs": rt.Engine(L, rt.apps.bfs_program()),
                   "sssp": rt.Engine(L, rt.apps.sssp_program())}
    seq = {"bfs": [rt.bfs(L, int(v), engine=seq_engines["bfs"])
                   for v in sources],
           "sssp": [rt.sssp(L, int(v), engine=seq_engines["sssp"])
                    for v in sources]}
    report["batched_sequential_s"] = time.perf_counter() - t
    del seq_engines
    say("batched", sources=sources.tolist(),
        sequential_s=report["batched_sequential_s"])
    def lane_copy_setup(e) -> dict:
        """The layout's lane copy after engine ``e``'s first lane call
        (:meth:`FusedDCKernel.lane_edges`): its bytes, and the time that
        call spent building it (0 where the layout's engines built it
        before)."""
        copy = e._fused.lane_copy
        before = copy.build_s
        e._fused.lane_edges()
        return {"bytes": copy.nbytes(), "build_s": copy.build_s - before}

    batched_kernels = {
        "fused": (_build.FUSED_DC_INTERLEAVE, _build.FUSED_DC_LANES),
        "composed": (_build.DC_GATHER_LANES, _build.SEGMENT_COMBINE_LANES)}
    batched, batched_launches = {}, {}
    for path, kerns in batched_kernels.items():
        if path == "composed":
            os.environ[ENV_FUSED] = "0"
        t = time.perf_counter()
        engines = {"bfs": rt.Engine(L, rt.apps.bfs_program(), mode="dc"),
                   "sssp": rt.Engine(L, rt.apps.sssp_program(), mode="dc")}
        batch_setup_s = time.perf_counter() - t
        os.environ.pop(ENV_FUSED, None)
        # the fused lane form's edge copy, which the layout's engines share
        # and build at the first lane launch, built before the timed runs
        # (set-up)
        lane_setup = {name: lane_copy_setup(e)
                      for name, e in engines.items() if e.fused}
        check(all(e.fused == (path == "fused") for e in engines.values()),
              f"batched engines took the wrong DC path for {path}")
        batched_launches[path] = dict.fromkeys((kk.name for kk in kerns), 0)
        out = {}
        for name, app, keys in (("bfs", rt.bfs_multi, ("level", "parent")),
                                ("sssp", rt.sssp_multi, ("dist",))):
            _build.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out[name], wall = timed(
                lambda: app(L, sources, engine=engines[name]))
            launched = counts()
            peak = torch.cuda.max_memory_allocated() - base
            stats = out[name]["stats"]
            steps = len(stats)
            for kk in _build.KERNELS:
                want = steps if kk in kerns else 0
                check(launched[kk.name] == want,
                      f"batched {name} ({path}): {kk.name} launched "
                      f"{launched[kk.name]} times in {steps} steps, not "
                      f"{want}")
            for kk in kerns:
                batched_launches[path][kk.name] += launched[kk.name]
            regimes = dict(_build.DC_GATHER_LANES.regimes)
            check(path == "fused" or regimes["staged"] == steps,
                  f"batched {name}: dc_gather_lanes regimes {regimes}")
            for i, v in enumerate(sources):
                for key in keys:
                    check(np.array_equal(out[name][key][i],
                                         seq[name][i][key]),
                          f"batched {name} ({path}) lane {i} (source {v}): "
                          f"{key} differs from the sequential run")
            per_step = [st.lanes_active for st in stats]
            batched[f"{name}_{path}"] = {
                "lanes": lanes, "wall_s": wall,
                "engine_setup_s": batch_setup_s,
                "peak_bytes_above_engine": peak,
                "steps": steps, "lanes_active": per_step,
                "compactions": sum(n < lanes for n in per_step),
                "n_active": [st.n_active for st in stats],
                "step_wall_s": [st.wall_s for st in stats],
                "launches": {kk: v for kk, v in launched.items() if v},
                **({"dc_gather_lanes_regimes": regimes}
                   if path == "composed" else
                   {"lane_edges_setup": lane_setup[name]})}
            say("batched", app=name, path=path, **batched[f"{name}_{path}"])
        # the src lane against the host oracles
        lv, par = out["bfs"]["level"][0], out["bfs"]["parent"][0]
        check(np.array_equal(lv, want_level),
              f"batched bfs ({path}): the src lane's levels differ from scipy")
        reached = lv > 0
        check(bool(np.all(lv[par[reached]] == lv[reached] - 1)),
              f"batched bfs ({path}): parents are not one level up")
        dist = out["sssp"]["dist"][0]
        check(np.array_equal(np.isinf(dist), ~fin) and np.allclose(
            dist[fin], want_dist[fin], rtol=1e-5, atol=0),
              f"batched sssp ({path}): the src lane differs from Dijkstra")
        del engines, out
    report["batched"] = batched
    del seq

    # ---------------- payload ----------------
    # The 8-byte slice: sssp_with_parents from src in hybrid mode on each
    # DC lowering (the int64 fused_dc, or dc_gather + segment_combine, and
    # the int64 segment fold of the SC stream), against sssp's distances
    # and Dijkstra, its parents against the edge weights, and the same run
    # through the plain versions on the card; then sssp_parents_multi and a
    # cold bfs_seeded_multi over the batched phase's 16 sources, each step
    # one launch of each int64 lane form of its lowering.
    ew_src = np.repeat(np.arange(g.n, dtype=np.int64), g.out_degrees())
    ew_dst, ew_w = g.indices.astype(np.int64), g.weights

    def check_parents(res, tag):
        """dist[v] == f32(dist[parent[v]] + w(parent[v], v)) for every
        reached v != src (the least such sum over parallel edges)."""
        dist, par = res["dist"], res["parent"]
        reached = np.isfinite(dist)
        check(par[src] == src and bool(np.all(par[~reached] == -1)),
              f"{tag}: the source or an unreached vertex has a parent")
        sel = reached[ew_dst] & (ew_dst != src) & (par[ew_dst] == ew_src)
        best = np.full(g.n, np.inf, np.float32)
        np.minimum.at(best, ew_dst[sel],
                      (dist[ew_src[sel]] + ew_w[sel]).astype(np.float32))
        want = reached.copy()
        want[src] = False
        check(np.array_equal(best[want], dist[want]),
              f"{tag}: a parent's distance plus its edge's weight is not "
              "the vertex's distance")

    payload_rec, payload_launches = {}, {}
    path_kernels = {"fused": ("fused_dc", "segment_fold"),
                    "composed": ("dc_gather", "segment_combine",
                                 "segment_fold")}
    for path in ("fused", "composed"):
        if path == "composed":
            os.environ[ENV_FUSED] = "0"
        try:
            _build.reset_launch_counts()
            res, wall = timed(lambda: rt.sssp_with_parents(L, src))
            launched = counts()
            regimes = dict(_build.DC_GATHER.regimes)
        finally:
            os.environ.pop(ENV_FUSED, None)
        for name in path_kernels[path]:
            check(launched[name] > 0, f"payload ({path}): {name} was not "
                  "launched by sssp_with_parents")
        check(regimes["staged"] == launched["dc_gather"],
              f"payload ({path}): an 8-byte dc_gather launch did not stage "
              f"({regimes})")
        payload_launches[path] = launched
        check(np.array_equal(res["dist"], sssp_res["dist"]),
              f"payload ({path}): sssp_with_parents' dist differs from sssp")
        check(np.array_equal(np.isinf(res["dist"]), ~fin)
              and np.allclose(res["dist"][fin], want_dist[fin], rtol=1e-5,
                              atol=0),
              f"payload ({path}): dist differs from Dijkstra")
        check_parents(res, f"payload ({path})")
        if path == "fused":
            plain_eng = rt.Engine(L, rt.apps.sssp_parents_program(),
                                  plain=True)
            plain_res = rt.sssp_with_parents(L, src, engine=plain_eng)
            del plain_eng
            first = res
        else:
            plain_res = first
        for key in ("dist", "parent"):
            check(np.array_equal(res[key], plain_res[key]),
                  f"payload ({path}): {key} differs from the "
                  + ("plain versions' run" if path == "fused"
                     else "fused run"))
        stats = res["stats"]
        payload_rec[f"sssp_with_parents_{path}"] = {
            "wall_s": wall, "iterations": len(stats),
            "modes": [s.mode for s in stats],
            "iter_wall_s": [s.wall_s for s in stats],
            "reached": int(fin.sum()),
            "launches": {kk: v for kk, v in launched.items() if v},
            "dc_gather_regimes": regimes}
        say("payload", app="sssp_with_parents", path=path,
            **payload_rec[f"sssp_with_parents_{path}"])
    del first, plain_res

    t = time.perf_counter()
    sp_eng = rt.Engine(L, rt.apps.sssp_parents_program())
    seq_sp = [rt.sssp_with_parents(L, int(v), engine=sp_eng)
              for v in sources]
    del sp_eng
    payload_rec["sequential_s"] = time.perf_counter() - t
    cold_bfs = rt.bfs_multi(L, sources)
    wide_lane_kernels = {
        "fused": (_build.FUSED_DC_INTERLEAVE, _build.FUSED_DC_LANES),
        "composed": (_build.DC_GATHER_LANES, _build.SEGMENT_COMBINE_LANES)}
    for path, kerns in wide_lane_kernels.items():
        if path == "composed":
            os.environ[ENV_FUSED] = "0"
        try:
            engines = {
                "sssp_parents_multi": rt.Engine(
                    L, rt.apps.sssp_parents_program(), mode="dc"),
                "bfs_seeded_multi": rt.Engine(
                    L, rt.apps.bfs_seeded_program(), mode="dc")}
        finally:
            os.environ.pop(ENV_FUSED, None)
        # the lane form's edge copy (set-up)
        lane_setup = {name: lane_copy_setup(e)
                      for name, e in engines.items() if e.fused}
        for name, app, want in (
                ("sssp_parents_multi", rt.sssp_parents_multi,
                 lambda i, key: seq_sp[i][key]),
                ("bfs_seeded_multi", rt.bfs_seeded_multi,
                 lambda i, key: cold_bfs[key][i])):
            _build.reset_launch_counts()
            out, wall = timed(lambda: app(L, sources, engine=engines[name]))
            launched = counts()
            steps = len(out["stats"])
            for kk in _build.KERNELS:
                n_want = steps if kk in kerns else 0
                check(launched[kk.name] == n_want,
                      f"payload {name} ({path}): {kk.name} launched "
                      f"{launched[kk.name]} times in {steps} steps, not "
                      f"{n_want}")
            check(path == "fused"
                  or _build.DC_GATHER_LANES.regimes["staged"] == steps,
                  f"payload {name}: dc_gather_lanes regimes "
                  f"{_build.DC_GATHER_LANES.regimes}")
            for kk in kerns:
                payload_launches.setdefault(kk.name, 0)
                payload_launches[kk.name] += launched[kk.name]
            keys = (("dist", "parent") if name == "sssp_parents_multi"
                    else ("level", "parent"))
            for i, v in enumerate(sources):
                for key in keys:
                    check(np.array_equal(out[key][i], want(i, key)),
                          f"payload {name} ({path}) lane {i} (source {v}): "
                          f"{key} differs from the "
                          + ("sequential run" if name == "sssp_parents_multi"
                             else "bfs_multi lane"))
            per_step = [st.lanes_active for st in out["stats"]]
            payload_rec[f"{name}_{path}"] = {
                "lanes": lanes, "wall_s": wall, "steps": steps,
                "lanes_active": per_step,
                "step_wall_s": [st.wall_s for st in out["stats"]],
                "launches": {kk: v for kk, v in launched.items() if v},
                **({"lane_edges_setup": lane_setup[name]}
                   if name in lane_setup else {})}
            say("payload", app=name, path=path,
                **payload_rec[f"{name}_{path}"])
        del engines, out
    del seq_sp, cold_bfs, ew_src, ew_dst, ew_w
    report["payload"] = payload_rec

    # ---------------- serve ----------------
    # A GraphQueryServer on the symmetrized weighted graph (seeding needs
    # symmetry) with a query stream made from --seed: three rounds of 16
    # BFS, 16 SSSP and 4 SSSP-with-parents queries over 24 distinct
    # sources with repeats, each round submitted and drained before the
    # next, then one CC and one PageRank query.  Every answer against the
    # same app run alone on the card; later rounds must hit the exact
    # cache and seed at least one batch; every run_batched call of an
    # int64 program must be one launch of the int64 lane form per step.
    from repro_torch import obs
    from repro_torch.serve import GraphQuery, GraphQueryServer
    obs.reset()
    srv_rng = np.random.default_rng(args.seed)
    pool = srv_rng.choice(gs.n, 24, replace=False)
    _build.reset_launch_counts()
    t = time.perf_counter()
    srv = GraphQueryServer(S)
    setup = {"server_s": time.perf_counter() - t}
    batched_calls = []
    shared = srv._shared_engine

    def timed_shared(app, make_program):
        fresh = app not in srv._engines
        t0 = time.perf_counter()
        eng = shared(app, make_program)
        if fresh:
            torch.cuda.synchronize()
            setup[app] = time.perf_counter() - t0
            inner = eng.run_batched

            def run_batched(*a, **kw):
                c0 = counts()
                res = inner(*a, **kw)
                batched_calls.append({
                    "program": eng.program.name, "steps": len(res[2]),
                    "width": int(np.asarray(a[1]).shape[0]),
                    "launches": {kk: v - c0[kk] for kk, v in counts().items()
                                 if v != c0[kk]}})
                return res
            eng.run_batched = run_batched
        return eng

    srv._shared_engine = timed_shared
    seeded_sources = set()          # (app, source) answered landmark-seeded
    lookup = srv._lookup_landmarks

    def noted_lookup(app, extra, sources_):
        picks = lookup(app, extra, sources_)
        seeded_sources.update((app, int(s)) for s, pick in
                              zip(sources_, picks) if pick is not None)
        return picks

    srv._lookup_landmarks = noted_lookup
    answers, qid = {}, 0
    t = time.perf_counter()
    for _ in range(3):
        for app, count in (("bfs", 16), ("sssp", 16), ("sssp_parents", 4)):
            for s in srv_rng.choice(pool, count):
                srv.submit(GraphQuery(qid, app, {"source": int(s)}))
                qid += 1
        answers.update({q.qid: q for q in srv.run()})
    srv.submit(GraphQuery(qid, "cc", {}))
    srv.submit(GraphQuery(qid + 1, "pagerank", {"iters": 10}))
    answers.update({q.qid: q for q in srv.run()})
    serve_s = time.perf_counter() - t
    serve_launches = counts()
    check(len(answers) == qid + 2, "the server lost a query")
    # every answer against the same app alone on the card: bit-exact, but
    # for an SSSP answer from a landmark-seeded lane, which the reference's
    # seeding leaves within f32 rounding below the cold run where the seed
    # fl(d_L(v) + d_L(s)) rounds below the cold path sum (its
    # upper-bound argument holds in exact arithmetic; the port reproduces
    # the reference, see tests/test_torch_serve.py): there, equal
    # reachability, never above the cold run, and within rtol 1e-5 of it
    seeded_diff = {"answers": 0, "vertices": 0, "max_rel": 0.0}

    def same_answer(app, s, key, got, want):
        if np.array_equal(got, want):
            return True
        if app != "sssp" or (app, s) not in seeded_sources:
            return False
        fin_w = np.isfinite(want)
        if not (np.array_equal(np.isfinite(got), fin_w)
                and bool(np.all(got[fin_w] <= want[fin_w]))
                and np.allclose(got[fin_w], want[fin_w], rtol=1e-5, atol=0)):
            return False
        d = got != want
        seeded_diff["answers"] += 1
        seeded_diff["vertices"] += int(d.sum())
        seeded_diff["max_rel"] = max(seeded_diff["max_rel"], float(np.max(
            (want[d] - got[d]) / want[d])))
        return True

    alone = {"bfs": (rt.bfs, rt.apps.bfs_program(), ("level", "parent")),
             "sssp": (rt.sssp, rt.apps.sssp_program(), ("dist",)),
             "sssp_parents": (rt.sssp_with_parents,
                              rt.apps.sssp_parents_program(),
                              ("dist", "parent"))}
    t = time.perf_counter()
    for app, (fn, program, keys) in alone.items():
        eng = rt.Engine(S, program)
        cache_alone = {}
        for q in answers.values():
            if q.app != app:
                continue
            s = q.params["source"]
            if s not in cache_alone:
                cache_alone[s] = fn(S, s, engine=eng)
            for key in keys:
                check(same_answer(app, s, key, q.result[key],
                                  cache_alone[s][key]),
                      f"serve: {app} from {s}: {key} differs from the app "
                      "run alone")
        del eng, cache_alone
    cc_q, pr_q = answers[qid], answers[qid + 1]
    check(np.array_equal(cc_q.result["label"],
                         rt.connected_components(S)["label"]),
          "serve: cc differs from the app run alone")
    pr_l1 = float(np.abs(pr_q.result["pr"].astype(np.float64)
                         - rt.pagerank(S, iters=10)["pr"]).sum())
    check(pr_l1 <= 1e-6, f"serve: pagerank is {pr_l1} (L1) from the app "
          "run alone")
    alone_s = time.perf_counter() - t
    events = obs.events()
    check(all(obs.validate_event(e) == [] for e in events),
          "serve: an obs event breaks the schema")
    seeded = [e for e in events if e["event"] == "seeded_batch"]
    check(srv.cache_hits > 0, "serve: no exact-cache hit")
    check(len(seeded) > 0, "serve: no landmark-seeded batch")
    wide_programs = ("sssp_parents", "bfs_seeded")
    check(any(c["program"] in wide_programs for c in batched_calls),
          "serve: no int64 program ran batched")
    for c in batched_calls:
        want = ({"fused_dc_interleave": c["steps"],
                 "fused_dc_lanes": c["steps"]} if c["steps"] else {})
        check(c["launches"] == want,
              f"serve: {c['program']} run_batched launched {c['launches']} "
              f"in {c['steps']} steps")
    serve_wide_lanes = sum(c["steps"] for c in batched_calls
                           if c["program"] in wide_programs)
    hists = obs.snapshot()["histograms"]
    tag = srv._layout_tag
    walls = {app: {p: hists[f"serve.query_wall_s{{app={app},layout={tag}}}"]
                   [p] for p in ("count", "p50", "p99")}
             for app in ("bfs", "sssp", "sssp_parents", "cc", "pagerank")}
    counters = obs.snapshot()["counters"]
    report["serve"] = {
        "queries": qid + 2, "distinct_sources": len(pool),
        "serve_s": serve_s, "alone_check_s": alone_s,
        "query_wall_s": walls,
        "batches": [{"app": e["app"], "batch": e["batch"],
                     "width": e["width"], "wall_s": e["wall_s"]}
                    for e in events if e["event"] == "serve_batch"],
        "run_batched": batched_calls,
        "cache_hits": srv.cache_hits, "cache_misses": srv.cache_misses,
        "semantic_hits": srv.semantic_hits,
        "semantic_misses": srv.semantic_misses,
        "seeded_batches": len(seeded),
        "seeded_sources": sorted(f"{a}:{s}" for a, s in seeded_sources),
        "seeded_sssp_vs_alone": seeded_diff,
        "seed_iters_saved": sum(v for key, v in counters.items()
                                if key.startswith("serve.seed_iters_saved")),
        "warmed_landmarks": sum(v for key, v in counters.items()
                                if key.startswith("serve.warmed_landmarks")),
        "engine_setup_s": setup, "pagerank_l1_vs_alone": pr_l1,
        "launches": {kk: v for kk, v in serve_launches.items() if v},
        "int64_lane_steps": serve_wide_lanes}
    say("serve", **report["serve"])
    # the first round's queries and answers, which the dist phase serves
    # again from a sharded server
    serve_round1 = {q: answers[q] for q in range(36)}
    del answers, events

    # ---------------- delta ----------------
    # Dynamic graphs.  The deltas are benchmarks/bench_delta.py's
    # confined_delta: both endpoints of every edit in the first
    # ceil(0.05 k) partitions, the dirty share of an update to one region
    # of a graph.  A mixed delta (insertions and deletions of existing
    # edges) relaid out by apply_delta against a full build_layout of the
    # edited graph; BFS and SSSP resumed from the old fixpoint after an
    # insertion-only delta (Engine.run(resume_from=, touched=); BFS as the
    # packed seeded program, whose relaxation is exact from any upper
    # bound), bit-exact with cold runs on each DC lowering; CC resumed and
    # PageRank warm-started on the symmetrized graph; the serve phase's
    # server swapped to the new symmetrized layout with the delta and
    # answering one round there; then the telemetry the run recorded.
    from repro_torch.apps.bfs import bfs_seeded_pack
    from repro_torch.serve import cache as cache_lib
    obs.reset()
    delta_rec = report["delta"] = {}
    d_rng = np.random.default_rng(args.seed + 1)
    hi = min(int(np.ceil(0.05 * L.k)) * L.q, g.n)
    geometry = dict(k=L.k, edge_tile=L.edge_tile, msg_tile=L.msg_tile,
                    fold_tile=L.fold_tile, fold_q=L.fold_q)
    dc_kernels = {"fused": ("fused_dc",),
                  "composed": ("dc_gather", "segment_combine")}

    def confined_inserts(layout, count, symmetric=False):
        d = rt.DeltaBuffer.for_layout(layout)
        u, v = d_rng.integers(0, hi, count), d_rng.integers(0, hi, count)
        w = (d_rng.random(count) + 0.1).astype(np.float32)
        d.insert(u, v, w)
        if symmetric:
            d.insert(v, u, w)
        return d

    def same_layout(got, want, what):
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                check(a.dtype == b.dtype and a.shape == b.shape
                      and np.array_equal(a, b), f"{what}: {f.name} differs")
            else:
                check(a == b, f"{what}: {f.name} is {a}, not {b}")

    # relayout: 10,000 insertions and 1,000 deletions of existing edges
    d_mixed = confined_inserts(L, 10_000)
    e_src = np.repeat(np.arange(hi, dtype=np.int64),
                      np.diff(g.indptr[:hi + 1]))
    e_dst = g.indices[:int(g.indptr[hi])].astype(np.int64)
    pick = d_rng.choice(np.flatnonzero(e_dst < hi), 1000, replace=False)
    d_mixed.delete(e_src[pick], e_dst[pick])
    del e_src, e_dst
    t = time.perf_counter()
    L_inc = rt.apply_delta(L, d_mixed)
    apply_s = time.perf_counter() - t
    t = time.perf_counter()
    g_edit = d_mixed.edit_graph(g)
    edit_s = time.perf_counter() - t
    L_full = build_layout(g_edit, **geometry)
    rebuild_s = time.perf_counter() - t - edit_s
    same_layout(L_inc, L_full, "delta: apply_delta of the mixed delta")
    delta_rec["relayout"] = {
        "layout": "directed", "inserts": d_mixed.num_inserts,
        "deletes": d_mixed.num_deletes, "k": L.k,
        "dirty_src_parts": len(d_mixed.src_partitions()),
        "dirty_parts": len(d_mixed.dirty_partitions()),
        "apply_delta_s": apply_s, "edit_graph_s": edit_s,
        "build_layout_s": rebuild_s,
        "apply_over_rebuild": apply_s / (edit_s + rebuild_s),
        "equal_to_rebuild": True}
    say("delta", **delta_rec["relayout"])
    del L_inc, L_full, g_edit

    # resume on the directed layout after 10,000 confined insertions
    d_ins = confined_inserts(L, 10_000)
    t = time.perf_counter()
    L2 = rt.apply_delta(L, d_ins)
    delta_rec["resume_apply_delta_s"] = time.perf_counter() - t
    vid = torch.arange(n_pad, dtype=torch.int32, device=dev).view(
        torch.uint32)
    src_frontier = np.zeros(n_pad, bool)
    src_frontier[src] = True

    def cold_start(app):
        if app == "bfs":
            level = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
            level[src] = 0
            return rt.apps.bfs_seeded_program(), {
                "best": bfs_seeded_pack(level, torch.full_like(level, src)),
                "vid": vid}
        dist = torch.full((n_pad,), float("inf"), device=dev)
        dist[src] = 0.0
        return rt.apps.sssp_program(), {"dist": dist}

    def iter_record(stats, wall):
        return {"iterations": len(stats), "wall_s": wall,
                "modes": [s.mode for s in stats],
                "dc_iterations": sum(s.dc_parts > 0 for s in stats),
                "iter_wall_s": [s.wall_s for s in stats]}

    def engine_iters_recorded(fn, stats_of=lambda out: out[2]):
        """``fn()``'s result and wall; each of its stats must have been
        recorded as one engine_iter event."""
        n0 = len(obs.events("engine_iter"))
        out, wall = timed(fn)
        check(len(obs.events("engine_iter")) - n0 == len(stats_of(out)),
              "delta: engine_iter events differ from the run's stats")
        return out, wall

    delta_rec["resume"] = {}
    for app in ("bfs", "sssp"):
        prog, state0 = cold_start(app)
        (old, _, old_stats), old_wall = timed(
            lambda: rt.Engine(L, prog).run(dict(state0), src_frontier))
        for path in ("fused", "composed"):
            if path == "composed":
                os.environ[ENV_FUSED] = "0"
            try:
                _build.reset_launch_counts()
                eng, setup_s = timed(lambda: rt.Engine(L2, prog))
                (warm, _, w_stats), w_wall = engine_iters_recorded(
                    lambda: eng.run(resume_from=old, touched=d_ins))
                (cold, _, c_stats), c_wall = engine_iters_recorded(
                    lambda: eng.run(dict(state0), src_frontier))
                launched = counts()
            finally:
                os.environ.pop(ENV_FUSED, None)
            check(eng.fused == (path == "fused"),
                  f"delta: {app} engine took the wrong DC path")
            for key in state0:
                check(torch.equal(bits(warm[key]), bits(cold[key])),
                      f"delta: resumed {app} ({path}) {key} differs from "
                      "the cold run")
            for name in dc_kernels[path]:
                check(launched[name] > 0, f"delta: {name} was not launched "
                      f"by the {path} resumed {app} runs")
            delta_rec["resume"][f"{app}_{path}"] = {
                "engine_setup_s": setup_s, "old_iterations": len(old_stats),
                "old_wall_s": old_wall,
                "resumed": iter_record(w_stats, w_wall),
                "cold": iter_record(c_stats, c_wall), "bit_exact": True,
                "launches": {k: v for k, v in launched.items() if v}}
            say("delta", app=app, path=path,
                **delta_rec["resume"][f"{app}_{path}"])
        if app == "bfs":
            # the seeded program's answer is stock BFS's on the new layout
            key, payload_ = M.unpack_key_payload(warm["best"][:g.n])
            stock = rt.bfs(L2, src)
            reached = torch.isfinite(key)
            check(np.array_equal(
                torch.where(reached, key.to(torch.int32), -1).cpu().numpy(),
                stock["level"]) and np.array_equal(
                torch.where(reached, M.as_bits(payload_), -1).cpu().numpy(),
                stock["parent"]),
                "delta: resumed bfs differs from stock bfs on the new layout")
        del eng, warm, cold

    # refusals, before any launch: a delta with deletions, a PageRank program
    pr_eng = rt.Engine(L2, rt.apps.pagerank_program(L2.n), mode="dc")
    sssp_eng = rt.Engine(L2, rt.apps.sssp_program())
    _build.reset_launch_counts()
    refusals = {
        "deletion_delta": lambda: sssp_eng.run(resume_from=old,
                                               touched=d_mixed),
        "pagerank_program": lambda: pr_eng.run(
            resume_from={"pr": torch.zeros(n_pad, device=dev),
                         "deg": torch.zeros(n_pad, device=dev)},
            touched=d_ins)}
    for what, fn in refusals.items():
        try:
            fn()
            check(False, f"delta: resume with {what} did not raise")
        except ValueError:
            pass
    check(sum(counts().values()) == 0, "delta: a refused resume launched")
    delta_rec["refused_before_launch"] = sorted(refusals)
    del pr_eng, sssp_eng, old, L2, d_mixed

    # the symmetrized layout: 10,000 symmetric insertions
    ds = confined_inserts(S, 10_000, symmetric=True)
    t = time.perf_counter()
    S2 = rt.apply_delta(S, ds)
    sym = {"apply_delta_s": time.perf_counter() - t,
           "inserts": ds.num_inserts,
           "dirty_parts": len(ds.dirty_partitions())}
    _build.reset_launch_counts()
    cc_old, sym["cc_old_wall_s"] = timed(lambda: rt.connected_components(S))
    cc_warm, cc_warm_wall = engine_iters_recorded(
        lambda: rt.connected_components(S2, resume_labels=cc_old["label"],
                                        touched=ds),
        stats_of=lambda out: out["stats"])
    cc_cold, cc_cold_wall = timed(lambda: rt.connected_components(S2))
    check(np.array_equal(cc_warm["label"], cc_cold["label"]),
          "delta: resumed cc differs from the cold run")
    sym["cc"] = {"resumed": iter_record(cc_warm["stats"], cc_warm_wall),
                 "cold": iter_record(cc_cold["stats"], cc_cold_wall),
                 "bit_exact": True}
    pr_old, sym["pagerank_old_120_wall_s"] = timed(
        lambda: rt.pagerank(S, iters=120)["pr"])
    pr_warm, pr_warm_wall = timed(
        lambda: rt.pagerank(S2, iters=60, pr0=pr_old)["pr"])
    pr_ref, pr_ref_wall = timed(lambda: rt.pagerank(S2, iters=160)["pr"])
    diff = np.abs(pr_warm.astype(np.float64) - pr_ref)
    sym["pagerank"] = {"warm_60_wall_s": pr_warm_wall,
                       "cold_160_wall_s": pr_ref_wall,
                       "max_abs": float(diff.max()), "l1": float(diff.sum())}
    check(sym["pagerank"]["max_abs"] <= 1e-6 and sym["pagerank"]["l1"]
          <= 1e-5, f"delta: pagerank(pr0=) is {sym['pagerank']} from 160 "
          "cold iterations")
    sym["launches"] = {k: v for k, v in counts().items() if v}
    check(sym["launches"].get("fused_dc", 0) > 0,
          "delta: the symmetrized runs launched no fused_dc")
    delta_rec["symmetrized"] = sym
    say("delta", layout="symmetrized", **sym)
    del cc_old, cc_warm, cc_cold, pr_old, pr_warm, pr_ref

    # the server: swap to the new symmetrized layout with the delta
    old_tag = srv._layout_tag
    changed = {p for p, (a, b) in enumerate(zip(
        cache_lib.partition_tags(S), cache_lib.partition_tags(S2)))
        if a != b}
    sem_old = [key for key in srv.cache.keys() if isinstance(key, str)
               and key.startswith(f"sem|{old_tag}|")]
    clean = sum(1 for key in sem_old if not set(np.asarray(
        srv.cache.get(key)["parts"]).tolist()) & changed)
    epoch0 = srv.epoch
    _build.reset_launch_counts()
    t = time.perf_counter()
    srv.swap_layout(S2, delta=ds)
    swap_s = time.perf_counter() - t
    swap = obs.events("epoch_swap")[-1]
    check(srv.epoch == epoch0 + 1, "delta: the epoch did not bump")
    check(not any(f"|{old_tag}|" in key for key in srv.cache.keys()),
          "delta: a key of the old tag survived the swap")
    check(swap["delta"] is True and swap["migrated"] == clean
          and swap["changed_parts"] == len(changed),
          f"delta: epoch_swap {swap} against {clean} clean landmarks of "
          f"{len(sem_old)} and {len(changed)} changed partitions")
    seeded_sources.clear()
    qid += 2                       # past the serve phase's CC and PageRank
    round_qids = []
    for app in ("bfs", "sssp"):
        for s in srv_rng.choice(pool, 8):
            srv.submit(GraphQuery(qid, app, {"source": int(s)}))
            round_qids.append(qid)
            qid += 1
    t = time.perf_counter()
    done = {q.qid: q for q in srv.run() if q.qid >= round_qids[0]}
    round_s = time.perf_counter() - t
    check(sorted(done) == round_qids, "delta: the server lost a query")
    for app, (fn, program, keys) in alone.items():
        if app == "sssp_parents":
            continue
        eng = rt.Engine(S2, program)
        for q in done.values():
            if q.app == app:
                s = q.params["source"]
                want = fn(S2, s, engine=eng)
                for key in keys:
                    check(same_answer(app, s, key, q.result[key], want[key]),
                          f"delta: served {app} from {s} after the swap: "
                          f"{key} differs from the app alone")
        del eng
    hists = obs.snapshot()["histograms"]
    delta_rec["serve"] = {
        "swap_s": swap_s, "evicted": swap["evicted"],
        "migrated": swap["migrated"], "changed_parts": swap["changed_parts"],
        "old_sem_entries": len(sem_old), "round_s": round_s,
        "query_wall_s": {app: {p: hists[
            f"serve.query_wall_s{{app={app},layout={srv._layout_tag}}}"][p]
            for p in ("count", "p50", "p99")} for app in ("bfs", "sssp")},
        "seeded_sources": sorted(f"{a}:{s}" for a, s in seeded_sources),
        "launches": {k: v for k, v in counts().items() if v}}
    say("delta", layout="served", **delta_rec["serve"])
    del srv, done

    # telemetry: a batch whose lanes drain at different steps (the
    # lowest-degree vertex's drains first), then the stream as a whole
    lone = int(np.argmin(np.where(np.arange(n_pad) == src, n_pad,
                                  S2.deg)[:g.n]))
    rt.bfs_multi(S2, [src, lone])
    events = obs.events()
    kinds = collections.Counter(e["event"] for e in events)
    need = ("engine_iter", "batch_iter", "lane_compaction", "fused_run",
            "delta_apply", "epoch_swap", "serve_batch")
    check(all(kinds[name] > 0 for name in need),
          f"delta: the event stream lacks one of {need}: {dict(kinds)}")
    check(all(obs.validate_event(e) == [] for e in events),
          "delta: an obs event breaks the schema")
    obs_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    written = obs.export.write_jsonl(obs_dir / "events.jsonl")
    tool = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_obs_schema.py"),
         str(obs_dir / "events.jsonl"), "--require",
         "engine_iter,batch_iter,fused_run,delta_apply,epoch_swap"],
        capture_output=True, text=True)
    check(tool.returncode == 0, f"delta: check_obs_schema.py failed: "
          f"{tool.stdout[-2000:]} {tool.stderr[-2000:]}")
    telemetry = {"events": dict(kinds), "written": written,
                 "check_obs_schema": tool.stdout.strip().splitlines()[-1:]}

    # one PageRank run iteration on each lowering under obs.trace
    pr_state = {"pr": torch.full((n_pad,), 1.0 / L.n, device=dev),
                "deg": torch.from_numpy(L.deg.astype(np.float32)).to(dev)}
    all_front = np.zeros(n_pad, bool)
    all_front[:L.n] = True
    # each scope's kernel, by its row and the fragments of its name
    traced = {"fused": {"ppm.fused_dc.cuda": ("fused_dc", ("FusedEdges",))},
              "composed": {"ppm.scatter.cuda": ("dc_gather",
                                                ("staged_kernel",
                                                 "l2_kernel")),
                           "ppm.gather.cuda": ("segment_combine",
                                               ("CombineEdges",))}}
    telemetry["trace"] = {}
    pr_engines = {}
    for path, scopes in traced.items():
        if path == "composed":
            os.environ[ENV_FUSED] = "0"
        try:
            eng = pr_engines[path] = rt.Engine(
                L, rt.apps.pagerank_program(L.n), mode="dc")
        finally:
            os.environ.pop(ENV_FUSED, None)
        eng.run(dict(pr_state), all_front, max_iters=1, until_empty=False)
        trace_path = Path(args.report).with_name(
            f"chip_smoke_trace_pagerank_{path}.json")
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        with obs.override_enabled(True):
            with obs.trace(trace_path):
                eng.run(dict(pr_state), all_front, max_iters=1,
                        until_empty=False)
                torch.cuda.synchronize()
        found = scope_kernels(trace_path, list(scopes))
        for scope, (row, fragments) in scopes.items():
            rec = found[scope]
            mine = {name: us for name, us in rec["kernels"].items()
                    if any(f in name for f in fragments)}
            check(rec["scopes"] > 0 and mine,
                  f"delta: the {path} trace holds no device record of "
                  f"{row} inside {scope}: {rec}")
            rec["kernel_us_per_scope"] = sum(mine.values()) / rec["scopes"]
            rec["row_device_ms"] = report[row]["device_ms"]
            say("delta", trace=path, scope=scope, **rec)
        telemetry["trace"][path] = dict(found, file=str(trace_path))

    # what telemetry costs.  With obs on and off, in turns: PageRank's 10
    # run iterations (host clock, ending in a synchronize), and the fused DC
    # wrapper's host time.  Alone, the two things obs adds on that path:
    # recording one iteration (the loop is host-driven, so that adds to each
    # iteration's wall) and a kernel scope entered with no profiler running
    def spread(values):
        q1, med, q3 = np.percentile(values, [25, 50, 75])
        return {"median": float(med), "q1": float(q1), "q3": float(q3),
                "min": float(np.min(values))}

    def per_call_us(fn, reps):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e6 / reps

    def scope():
        with obs.kernel_scope("ppm.fused_dc.cuda"):
            pass

    eng = pr_engines["fused"]
    walls = {"on": [], "off": []}
    for turn in ("on", "off", "off", "on") * 6:
        with obs.override_enabled(turn == "on"):
            walls[turn].append(1e2 * timed(lambda: eng.run(
                dict(pr_state), all_front, max_iters=10,
                until_empty=False))[1])
    table = payload(ns, torch.float32)
    live = torch.ones(ns, dtype=torch.bool, device=dev)
    host = {"on": [], "off": []}
    for turn in ("on", "off", "off", "on") * 4:
        with obs.override_enabled(turn == "on"):
            host[turn].append(host_ms(lambda: eng._fused(table, live), 200))
    _, _, pr_stats = eng.run(dict(pr_state), all_front, max_iters=1,
                             until_empty=False)
    record_us = per_call_us(lambda: obs.record_engine_iter(
        "core", pr_stats[0], dc_e=1, sc_e=0), 20_000)
    obs.reset()
    scope_us = {}
    for turn in ("on", "off"):
        with obs.override_enabled(turn == "on"):
            scope_us[turn] = per_call_us(scope, 100_000)
    telemetry["cost"] = c = {
        "pagerank_run_iter_ms": {k: spread(v) for k, v in walls.items()},
        "fused_dc_wrapper_host_ms": {k: spread(v) for k, v in host.items()},
        "record_engine_iter_us": record_us, "kernel_scope_us": scope_us}
    iter_ms = {k: v["median"] for k, v in c["pagerank_run_iter_ms"].items()}
    c["pagerank_run_iter_change"] = iter_ms["on"] / iter_ms["off"] - 1
    c["record_share_of_iter"] = record_us / (1e3 * iter_ms["off"])
    c["fused_dc_host_us_change"] = 1e3 * (
        c["fused_dc_wrapper_host_ms"]["on"]["median"]
        - c["fused_dc_wrapper_host_ms"]["off"]["median"])
    delta_rec["telemetry"] = telemetry
    say("delta", telemetry=telemetry)
    shutil.rmtree(obs_dir)
    del pr_engines, eng, S2, ds, d_ins, table, live


    # ---------------- local ----------------
    # Nibble, heat-kernel PageRank and PageRank-Nibble from src, on each DC
    # lowering, against the same app through the plain versions on the card
    # (Engine(plain=True)): f32 adds run in another order, so within L1
    # LOCAL_L1 over the vertices (mass 1 in all).  In hybrid mode, the apps'
    # own; and in dc mode, where every iteration runs the DC stream, which
    # Eq. 1 does not choose for these frontiers at this scale.
    LOCAL_L1 = 1e-5
    local_apps = {
        "nibble": (rt.nibble, lambda: rt.apps.nibble_program(1e-4),
                   ("pr",)),
        "heat_kernel_pr": (rt.heat_kernel_pr,
                           lambda: rt.apps.heat_kernel_program(5.0, 1e-5),
                           ("hkpr",)),
        "pagerank_nibble": (rt.pagerank_nibble,
                            lambda: rt.apps.pagerank_nibble_program(0.15,
                                                                    1e-5),
                            ("ppr", "residual"))}
    dc_kernels = {"fused": ("fused_dc",),
                  "composed": ("dc_gather", "segment_combine")}
    local = {}
    for path, mode in itertools.product(("fused", "composed"),
                                        ("hybrid", "dc")):
        if path == "composed":
            os.environ[ENV_FUSED] = "0"
        try:
            for name, (app, program, keys) in local_apps.items():
                _build.reset_launch_counts()
                res, wall = timed(lambda: app(L, src, mode=mode))
                launched = counts()
                plain_eng = rt.Engine(L, program(), mode=mode, plain=True)
                plain_res, plain_wall = timed(
                    lambda: app(L, src, engine=plain_eng))
                del plain_eng
                stats = res["stats"]
                dc_iters = sum(st.dc_parts > 0 for st in stats)
                for kname in ("fused_dc", "dc_gather", "segment_combine"):
                    want = dc_iters if kname in dc_kernels[path] else 0
                    check(launched[kname] == want,
                          f"local {name} ({path}, {mode}): {kname} launched "
                          f"{launched[kname]} times, {dc_iters} DC "
                          "iterations")
                check(sum(launched.values()) > 0,
                      f"local {name} ({path}, {mode}) launched no kernel")
                check(mode == "hybrid" or dc_iters == len(stats),
                      f"local {name} ({path}, dc): an iteration ran no DC")
                l1 = {key: float(np.abs(res[key].astype(np.float64)
                                        - plain_res[key]).sum())
                      for key in keys}
                check(all(v <= LOCAL_L1 for v in l1.values()),
                      f"local {name} ({path}, {mode}): L1 {l1} from the "
                      f"plain run > {LOCAL_L1}")
                local[f"{name}_{path}_{mode}"] = {
                    "wall_s": wall, "iterations": len(stats),
                    "plain_iterations": len(plain_res["stats"]),
                    "plain_wall_s": plain_wall,
                    "modes": [st.mode for st in stats],
                    "n_active": [st.n_active for st in stats],
                    "iter_wall_s": [st.wall_s for st in stats],
                    "l1_vs_plain": l1, "l1_limit": LOCAL_L1,
                    "mass": float(res[keys[0]].astype(np.float64).sum()),
                    "launches": {kk: v for kk, v in launched.items() if v}}
                say("local", app=name, path=path, mode=mode,
                    **local[f"{name}_{path}_{mode}"])
        finally:
            os.environ.pop(ENV_FUSED, None)
    report["local"] = local

    # ---------------- dist ----------------
    def dist_phase() -> dict:
        """The multi-device engine on one rank of a process group of world
        size 1 (the card's machine holds one card): the phase's record."""
        import torch.distributed as tdist

        from repro_torch.dist import BACKENDS, make_mesh
        from repro_torch.dist import engine as de
        from repro_torch.graph.shard import shard_layout
        from repro_torch.serve import ServeConfig

        rec = {}
        store = tempfile.mkdtemp(prefix="chip_smoke_dist_")
        tdist.init_process_group(
            BACKENDS[dev.type], init_method=f"file://{store}/store",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh(dev.type)

            # ---- set-up: sharding beside build_layout, engine set-up split
            t = time.perf_counter()
            SL = shard_layout(L, 1)
            shard_s = time.perf_counter() - t
            t = time.perf_counter()
            SS = shard_layout(S, 1)
            shard_sym_s = time.perf_counter() - t
            rec["setup"] = {
                "shard_layout_s": shard_s, "shard_layout_sym_s": shard_sym_s,
                "build_layout_s": report["graph"]["layout_s"],
                "sym_and_build_layout_s": report["graph"]["sym_and_layout_s"],
                "S": SL.S, "ne_d": SL.ne_d, "ne_s": SL.ne_s,
                "cap_pair": SL.cap_pair, "S_sym": SS.S, "ne_d_sym": SS.ne_d,
                "engine_setup": {
                    name: engine_setup(True, name, lambda p=program:
                                         de.DistEngine(SL, p, mesh))
                    for name, program in (("bfs", rt.apps.bfs_program()),
                                          ("sssp", rt.apps.sssp_program()))}}
            say("dist", **rec["setup"])

            # ---- the dist main path: counts from 0 before it, read after it;
            # fused_stream launches split by table width (4 bytes, int64)
            _build.reset_launch_counts()
            flat = {"4byte": 0, "int64": 0}

            def run(fn, width="4byte"):
                c0 = counts()
                out, wall = timed(fn)
                launched = {k: v - c0[k] for k, v in counts().items()
                            if v != c0[k]}
                if width is not None:
                    flat[width] += launched.get("fused_stream", 0)
                return out, wall, launched

            single = {"bfs": bfs_res, "sssp": sssp_res, "cc": cc_res}
            calls = {"bfs": (lambda e: rt.bfs(L, src, engine=e), SL,
                             rt.apps.bfs_program, ("level", "parent")),
                     "sssp": (lambda e: rt.sssp(L, src, engine=e), SL,
                              rt.apps.sssp_program, ("dist",)),
                     "cc": (lambda e: rt.connected_components(S, engine=e), SS,
                            rt.apps.cc_program, ("label",))}
            apps = rec["apps"] = {}
            for mode in de.MODES:
                for name, (fn, sl, program, keys) in calls.items():
                    eng = de.DistEngine(sl, program(), mesh, mode=mode)
                    res, wall, launched = run(lambda: fn(eng))
                    for key in keys:
                        check(np.array_equal(res[key], single[name][key]),
                              f"dist {name} ({mode}): {key} differs from the "
                              "single-device engine")
                    stats = res["stats"]
                    # a DC iteration is one fused_stream launch, an SC one
                    # segment_fold launch, a hybrid_pp one two segment_fold
                    # launches (its DC and SC streams, composed)
                    it_modes = [s["mode"] for s in stats]
                    want = {"fused_stream": it_modes.count("dc"),
                            "segment_fold": it_modes.count("sc")
                            + 2 * it_modes.count("hybrid_pp")}
                    got = {kk: launched.get(kk, 0) for kk in want}
                    check(got == want, f"dist {name} ({mode}): launched "
                          f"{got}, not {want}, in {len(stats)} iterations")
                    apps[f"{name}_{mode}"] = {
                        "wall_s": wall, "iterations": len(stats),
                        "modes": [s["mode"] for s in stats],
                        "iter_wall_s": [s["wall_s"] for s in stats],
                        "wire_bytes": [s["wire_bytes"] for s in stats],
                        "launches": launched}
                    say("dist", app=name, mode=mode, **apps[f"{name}_{mode}"])
                    del eng

            # PageRank in dc for 10 iterations (run and run_fused), and on the
            # bf16 wire
            d, iters = 0.85, 10
            pr_eng = de.DistEngine(SL, rt.apps.pagerank_program(L.n), mesh,
                                   mode="dc")
            pr_run, wall_run, _ = run(lambda: rt.pagerank(
                L, iters=iters, engine=pr_eng, fused=False))
            pr_fused, wall_fused, _ = run(lambda: rt.pagerank(
                L, iters=iters, engine=pr_eng))
            want = pr_res["pr"].astype(np.float64)
            l1 = {name: float(np.abs(r["pr"].astype(np.float64) - want).sum())
                  for name, r in (("run", pr_run), ("run_fused", pr_fused))}
            check(max(l1.values()) <= 1e-6, f"dist pagerank L1 {l1} from the "
                  "single-device engine > 1e-6")
            bf16_eng = de.DistEngine(SL, rt.apps.pagerank_program(L.n), mesh,
                                     mode="dc", wire_bf16=True)
            pr_bf16, wall_bf16, _ = run(lambda: rt.pagerank(
                L, iters=iters, engine=bf16_eng, fused=False))
            f32 = pr_run["pr"].astype(np.float64)
            # each message rounds to bf16 with relative error <= 2**-9; an
            # iteration sends d * ||pr||_1 of mass through a column-stochastic
            # step, which does not grow an L1 error: after t iterations
            # ||pr_bf16 - pr_f32||_1 <= 2**-9 * ||pr||_1 * sum_{j<=t} d**j
            bf16_bound = 2.0 ** -9 * f32.sum() * d * (1 - d ** iters) / (1 - d)
            bf16_err = float(np.abs(pr_bf16["pr"].astype(np.float64)
                                    - f32).sum())
            check(bf16_err <= bf16_bound + 1e-6, f"dist pagerank on the bf16 "
                  f"wire: L1 {bf16_err} from f32 > {bf16_bound}")
            rec["pagerank"] = {
                "l1_vs_single_device": l1, "run_s": wall_run,
                "run_fused_s": wall_fused, "bf16_run_s": wall_bf16,
                "bf16_l1_vs_f32": bf16_err, "bf16_l1_bound": bf16_bound,
                "iter_wall_s": [s["wall_s"] for s in pr_run["stats"]],
                "wire_bytes_f32": pr_eng.wire_bytes_per_step(),
                "wire_bytes_bf16": bf16_eng.wire_bytes_per_step()}
            say("dist", **rec["pagerank"])
            del bf16_eng, pr_bf16

            # ---- batched: each lane against a sequential dist run in dc
            lanes = [int(v) for v in sources]
            batched = rec["batched"] = {}
            for name, multi, alone, program, keys, width in (
                    ("bfs", rt.bfs_multi, rt.bfs, rt.apps.bfs_program,
                     ("level", "parent"), "4byte"),
                    ("sssp_parents", rt.sssp_parents_multi,
                     rt.sssp_with_parents, rt.apps.sssp_parents_program,
                     ("dist", "parent"), "int64")):
                eng = de.DistEngine(SL, program(), mesh, mode="dc")
                res, wall, launched = run(
                    lambda: multi(L, lanes, engine=eng), width)
                seq, seq_s, seq_launched = run(
                    lambda: [alone(L, v, engine=eng) for v in lanes], width)
                for i in range(len(lanes)):
                    for key in keys:
                        check(np.array_equal(res[key][i], seq[i][key]),
                              f"dist {name}_multi lane {i}: {key} differs "
                              "from the sequential dist run")
                steps = len(res["stats"])
                batched[name] = {
                    "wall_s": wall, "sequential_s": seq_s, "steps": steps,
                    "lanes_per_step": [s.lanes_active for s in res["stats"]],
                    "launches": launched, "sequential_launches": seq_launched}
                say("dist", batched=name, **batched[name])
                del eng, res, seq
            check(np.array_equal(
                rt.sssp_with_parents(L, src, engine=de.DistEngine(
                    SL, rt.apps.sssp_parents_program(), mesh))["dist"],
                sssp_res["dist"]), "dist sssp_with_parents differs from sssp")
            rec["launches_by_width"] = dict(flat)

            # ---- serving: the serve phase's first round on a sharded server
            srv = GraphQueryServer(S, ServeConfig(sharded=SS, mesh=mesh),
                                   device=dev)
            for qid, q in serve_round1.items():
                srv.submit(GraphQuery(qid, q.app, dict(q.params)))
            served, wall, launched = run(lambda: {q.qid: q for q in srv.run()},
                                         None)
            keys = {"bfs": ("level", "parent"), "sssp": ("dist",),
                    "sssp_parents": ("dist", "parent")}
            cold = {}
            for qid, q in serve_round1.items():
                s = q.params["source"]
                for key in keys[q.app]:
                    got = served[qid].result[key]
                    if np.array_equal(got, q.result[key]):
                        continue
                    # the unsharded server answered from a landmark-seeded lane
                    # (f32 rounding below the cold run): the sharded server,
                    # which never seeds, must give the cold answer
                    check((q.app, s) in seeded_sources,
                          f"dist serve: {q.app} from {s}: {key} differs from "
                          "the unsharded server")
                    if (q.app, s) not in cold:
                        cold[(q.app, s)] = rt.sssp(S, s, device=dev)
                    check(np.array_equal(got, cold[(q.app, s)][key]),
                          f"dist serve: {q.app} from {s}: {key} differs from "
                          "the cold run")
            check(srv.semantic_hits == 0, "dist serve: a sharded lane seeded")
            check(all(type(e).__name__ == "DistEngine"
                      for e in srv._engines.values()),
                  "dist serve: a shared engine is not a DistEngine")
            rec["serve"] = {"queries": len(serve_round1), "wall_s": wall,
                            "answers_from_cold_run": len(cold),
                            "engines": sorted(srv._engines),
                            "launches": launched}
            say("dist", serve=rec["serve"])
            del srv, served, cold

            # every fused_stream launch of the dist main path took the
            # partitioned regime
            regimes = dict(_build.FUSED_STREAM.regimes)
            check(regimes == {"stream": 0,
                              "parts": _build.FUSED_STREAM.launches},
                  f"dist: fused_stream regimes {regimes} of "
                  f"{_build.FUSED_STREAM.launches} launches: not all "
                  "partitioned")
            rec["fused_stream_regimes"] = regimes

            # ---- the layout-free fused_dc at the dist DC step's shapes: the
            # received bin table (D*S + 1 slots) gathered through
            # in_msg_slot and folded into nv + 1 segments, in the partitioned
            # regime over the engine's ranges (as the engine launches it) and
            # in the stream regime (no parts: the control), each case
            # bit-exact with the plain version in both
            A = pr_eng.arrays
            slot, ev, dstl = A["in_msg_slot"], A["in_valid"], A["in_dst_local"]
            parts = A["in_parts"]
            m, ns, ne = SL.D * SL.S + 1, SL.nv + 1, SL.ne_d
            dv = dstl[ev]
            rec["flat_stream"] = {
                "tile": parts.tile, "parts": parts.part_off.numel() - 1,
                "valid_edges": int(dv.numel()),
                # what the stream regime's run combining can fold: valid
                # edges whose dst equals the previous valid edge's
                "adjacent_equal_dst": float(
                    (dv[1:] == dv[:-1]).sum()) / max(1, dv.numel() - 1)}
            say("dist", flat_stream=rec["flat_stream"])
            del dv
            err = {"4byte": 0.0, "int64": 0.0}
            cases = [(mo, dt, None) for mo in MONOIDS
                     for dt in (torch.float32, torch.int32, torch.uint32)]
            cases += [("min", torch.float32, add_weight),
                      ("min_with_payload", torch.int64, None),
                      ("min_with_payload", torch.int64, add_weight_to_key)]
            for monoid, dtype, fn in cases:
                table = (packed(m) if dtype == torch.int64
                         else payload(m, dtype))
                tvalid = torch.rand(m, device=dev) < 0.5
                w = A["in_w"] if fn is not None else None
                width = "int64" if dtype == torch.int64 else "4byte"
                want = ref_fused_scatter_fold(M.make(monoid, dtype), table,
                                              tvalid, slot, ev, dstl, ns,
                                              apply_weight=fn, w=w)
                for regime, p in (("parts", parts), ("stream", None)):
                    err[width] = max(err[width], max_abs_err(
                        fused_scatter_fold(table, tvalid, slot, ev, dstl, ns,
                                           monoid=monoid, apply_weight=fn,
                                           w=w, parts=p), want,
                        f"fused_dc[flat] {regime} {monoid} {dtype}"
                        + (f" {fn.__name__}" if fn else "")))
                del want
            live = torch.ones(m, dtype=torch.bool, device=dev)
            slot64 = slot.to(torch.int64)
            rows = rec["kernels"] = {}
            for name, monoid, dtype, fn, nbytes in (
                    ("fused_dc[flat]", "add", torch.float32, None,
                     ne * (4 + 4 + 1) + m * (4 + 1) + ns * (4 + 1)),
                    ("fused_dc[flat,int64]", "min_with_payload", torch.int64,
                     add_weight_to_key,
                     ne * (4 + 4 + 1 + 4) + m * (8 + 1) + ns * (8 + 1))):
                table = (packed(m) if dtype == torch.int64
                         else payload(m, dtype))
                w = A["in_w"] if fn is not None else None
                mono = M.make(monoid, dtype)
                # the yardstick folds the values the kernel folds, gathered
                # (and weighted) beforehand, untimed: index_add_ for add,
                # scatter_reduce_(amin) for the int64 min
                vals = table.index_select(0, slot64)
                if fn is not None:
                    vals = fn(vals, w)
                vals = torch.where(ev, vals, mono.identity)
                dst64 = torch.where(ev, dstl, ns - 1).to(torch.int64)
                acc = M.full((ns,), mono.identity, dtype, dev)
                library = ((lambda: acc.index_add_(0, dst64, vals))
                           if monoid == "add" else
                           (lambda: acc.scatter_reduce_(0, dst64, vals, "amin",
                                                        include_self=True)))
                width = "int64" if dtype == torch.int64 else "4byte"

                def call(p, t=table, mo=monoid, f=fn, wt=w):
                    return lambda: fused_scatter_fold(
                        t, live, slot, ev, dstl, ns, monoid=mo,
                        apply_weight=f, w=wt, parts=p)
                rows[name] = {
                    "case": f"{monoid} {dtype}" + (f" {fn.__name__}" if fn
                                                   else ""),
                    "regime": "parts",
                    "shape": {"table": m, "edges": ne, "num_segments": ns,
                              "parts": parts.part_off.numel() - 1,
                              "tile": parts.tile},
                    **kernel_times(call(parts), 20),
                    "plain_ms": median_ms(lambda: ref_fused_scatter_fold(
                        mono, table, live, slot, ev, dstl, ns, apply_weight=fn,
                        w=w), 3),
                    "library_ms": median_ms(library, 20),
                    "bytes": nbytes, "bound_ms": bound_ms(nbytes),
                    "max_abs_err": err[width], "launches": flat[width],
                    "controls": {"stream_regime": {
                        "regime": "stream", **kernel_times(call(None), 20),
                        "bound_ms": bound_ms(nbytes)}}}
                say("dist", kernel=name, **rows[name])
                del vals, dst64, acc, table

            # ---- the dist DC step by part, beside the single-device fused DC
            # step, at PageRank's step (every vertex of [0, n) live)
            prog, nv = pr_eng.program, SL.nv
            state = {"pr": torch.full((nv,), 1.0 / L.n, device=dev),
                     "deg": torch.from_numpy(L.deg.astype(np.float32)).to(dev)}
            act = torch.zeros(nv, dtype=torch.bool, device=dev)
            act[:L.n] = True
            msgs = prog.scatter_fn(state)
            out_vals, flag = de._bins_out(prog, msgs, act, A, torch.float32)
            rv, rf = de._bin_table(out_vals, flag, 0.0, mesh, 0,
                                   wire_bitmap=True)
            fold, fused = de._resolve_fold(prog), de._resolve_fused(prog)
            eng1 = rt.Engine(L, rt.apps.pagerank_program(L.n), mode="dc",
                             device=dev)
            all_dc = np.ones(L.k, bool)
            steps = rec["steps"] = {"dc_ms": {
                "scatter": median_ms(lambda: de._bins_out(
                    prog, msgs, act, A, torch.float32), 10),
                "exchange": median_ms(lambda: de._bin_table(
                    out_vals, flag, 0.0, mesh, 0, wire_bitmap=True), 10),
                "fold": median_ms(lambda: de._gather_bins(
                    prog, pr_eng.meta, rv, rf, A, fold, fused, False), 10),
                "whole_step": median_ms(lambda: pr_eng._dc(
                    state, act, A, 0), 10),
                "single_device_fused_step": median_ms(lambda: eng1.step(
                    state, act, all_dc, 0), 10)},
                "dc_wire_bytes": pr_eng.wire_bytes_per_step()}
            del eng1, rv, rf, out_vals, flag

            # one SC step in each form, from BFS's second frontier (the
            # source's out-neighbours); the dense form moves D * cap_pair slots
            beng = de.DistEngine(SL, rt.apps.bfs_program(), mesh, mode="sc")
            bstate = {"parent": torch.full((nv,), -1, dtype=torch.int32,
                                           device=dev),
                      "level": torch.full((nv,), -1, dtype=torch.int32,
                                          device=dev),
                      "vid": torch.arange(nv, dtype=torch.int32,
                                          device=dev).view(torch.uint32)}
            front = torch.zeros(nv, dtype=torch.bool, device=dev)
            front[torch.from_numpy(g.indices[g.indptr[src]:g.indptr[src + 1]]
                                   .astype(np.int64)).to(dev)] = True
            e_act = int((front * beng.deg).sum())
            sc = {}
            for ragged in (False, True):
                step = de.build_sc_step(beng.program, beng.meta, mesh,
                                        ragged=ragged)
                sc[ragged] = step(bstate, front, beng.arrays, 1)
                steps[f"sc_{'ragged' if ragged else 'dense'}_ms"] = median_ms(
                    lambda: step(bstate, front, beng.arrays, 1), 10)
            check(torch.equal(sc[False][1], sc[True][1]) and all(
                torch.equal(sc[False][0][key], sc[True][0][key])
                for key in bstate),
                "dist: the dense and ragged SC steps differ")
            steps.update(sc_active_vertices=int(front.sum()),
                         sc_active_edges=e_act,
                         sc_wire_bytes=int(beng._sc_per_edge * e_act),
                         sc_dense_slots=SL.D * SL.cap_pair)
            say("dist", steps=steps)
            del beng, sc, pr_eng
        finally:
            tdist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
        return rec

    report["dist"] = dist_phase()
    del serve_round1

    # ---------------- tuning ----------------
    # on a graph of --scale - 2, a quarter of the edges: the sweep builds
    # a layout on the host for each geometry, and the readback one more
    tune_scale = args.scale - 2
    gt = rmat(tune_scale, 16, seed=args.seed, weighted=True)
    tdir = tempfile.mkdtemp(prefix="chip_smoke_tuning_")
    t = time.perf_counter()
    _build.reset_launch_counts()
    geom = tuning.autotune(gt, k=K_PARTS, device="cuda", force=True,
                           cache_dir=tdir)
    tuning_launches = counts()
    tune_s = time.perf_counter() - t
    rec = json.loads(next(Path(tdir).glob("*.json")).read_text())
    for row in rec["sweep"]:
        say("tuning", **row)
    check(tuning_launches["spmv_block"] > 0,
          "kernel spmv_block was not launched by the tuning sweep")
    os.environ[tuning.ENV_DIR] = tdir
    t = time.perf_counter()
    Lw = build_layout(gt, k=K_PARTS)
    layout_s = time.perf_counter() - t
    del os.environ[tuning.ENV_DIR]
    shutil.rmtree(tdir)
    check((Lw.edge_tile, Lw.msg_tile) == (geom.edge_tile, geom.msg_tile),
          f"build_layout took tiles ({Lw.edge_tile}, {Lw.msg_tile}), not the "
          f"tuned ({geom.edge_tile}, {geom.msg_tile})")
    del Lw, gt
    report["tuning"] = {"scale": tune_scale,
                        "winner": dataclasses.asdict(geom),
                        "sweep": rec["sweep"], "autotune_s": tune_s,
                        "tuned_layout_s": layout_s,
                        "launches": tuning_launches}
    say("tuning", winner=report["tuning"]["winner"], autotune_s=tune_s,
        tuned_layout_s=layout_s, launches=tuning_launches)

    # ---------------- lm ----------------
    t = time.perf_counter()
    c0 = counts()
    report["lm"] = lm_phase(dev, args.seed)
    report["lm"]["ppm_launches"] = {name: counts()[name] - c0[name]
                                    for name in c0}
    check(not any(report["lm"]["ppm_launches"].values()),
          "the lm phase launched a GPOP kernel")
    report["lm"]["phase_s"] = time.perf_counter() - t
    say("lm", phase_s=report["lm"]["phase_s"])

    def row(name, source, replaces, launches_n, err, rec, bound):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": launches_n, "max_abs_err": err, "ms": rec["ms"],
                "device_ms": rec["device_ms"], "call_ms": rec["call_ms"],
                "host_ms": rec["host_ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": bound, "bound_by": "bytes",
                "library_ms": rec["library_ms"]}

    def controls(rec):
        """The same inputs' control rows, by their times (and regimes)."""
        return {name: {key: c[key]
                       for key in ("regime", "ms", "device_ms", "bound_ms")
                       if key in c}
                for name, c in rec["controls"].items()}

    kernels = [
        dict(row("fused_dc", "fused_dc.cu", "fused_step.py:192",
                 launches["fused_dc"], fused_err, report["fused_dc"],
                 report["fused_dc"]["bound_ms"]),
             controls=controls(report["fused_dc"])),
        row("segment_fold", "segment_fold.cu", "fold_two_level.py:158",
            launches["segment_fold"], fold_err, fold_rows["n_pad_plus_1"],
            fold_rows["n_pad_plus_1"]["bound_ms"]),
        dict(row("dc_gather", "dc_gather.cu", "dc_gather.py:62",
                 composed_launches["dc_gather"], gather_err,
                 report["dc_gather"], report["dc_gather"]["bound_ms"]),
             regime=report["dc_gather"]["regime"],
             controls=controls(report["dc_gather"])),
        dict(row("segment_combine", "segment_combine.cu",
                 "segment_combine.py:122",
                 composed_launches["segment_combine"], combine_err,
                 report["segment_combine"],
                 report["segment_combine"]["bound_ms"]),
             controls=controls(report["segment_combine"])),
        row("spmv_block", "spmv_block.cu", "spmv_block.py:69",
            tuning_launches["spmv_block"], spmv_err, rows[True],
            rows[True]["bound_ms"]),
        # the lane forms, launched by the batched phase
        row("fused_dc_interleave[lanes=16]", "fused_dc.cu",
            "fused_step.py:192",
            batched_launches["fused"]["fused_dc_interleave"],
            lane_err["fused_dc_interleave"], report["fused_dc_interleave"],
            report["fused_dc_interleave"]["bound_ms"]),
        dict(row("fused_dc[lanes=16]", "fused_dc.cu", "fused_step.py:192",
                 batched_launches["fused"]["fused_dc_lanes"],
                 lane_err["fused_dc"], report["fused_dc_lanes"],
                 report["fused_dc_lanes"]["bound_ms"]),
             lane_edges=report["fused_dc_lanes"]["lane_edges"],
             controls=controls(report["fused_dc_lanes"])),
        dict(row("dc_gather[lanes=16]", "dc_gather.cu", "dc_gather.py:62",
                 batched_launches["composed"]["dc_gather_lanes"],
                 lane_err["dc_gather"], report["dc_gather_lanes"],
                 report["dc_gather_lanes"]["bound_ms"]),
             regime=report["dc_gather_lanes"]["regime"],
             controls=controls(report["dc_gather_lanes"])),
        dict(row("segment_combine[lanes=16]", "segment_combine.cu",
                 "segment_combine.py:122",
                 batched_launches["composed"]["segment_combine_lanes"],
                 lane_err["segment_combine"], report["segment_combine_lanes"],
                 report["segment_combine_lanes"]["bound_ms"]),
             controls=controls(report["segment_combine_lanes"])),
    ]

    # the 8-byte min, launched by the payload phase (and, for the fused
    # lane form, the serve phase's int64 batches)
    def wide_entry(name, source, replaces, launches_n, extra=None):
        rec = wide[name]
        out = row(name, source, replaces, launches_n, rec["max_abs_err"],
                  rec, rec["bound_ms"])
        if "controls" in rec:
            out["controls"] = controls(rec)
        if extra is not None:
            c = wide[extra]
            out.setdefault("controls", {})[extra] = {
                key: c[key] for key in ("ms", "device_ms", "bound_ms")}
        for key in ("regime", "library_fill_ms", "lane_edges"):
            if key in rec:
                out[key] = rec[key]
        return out

    kernels += [
        wide_entry("fused_dc[int64]", "fused_dc.cu", "fused_step.py:192",
                   payload_launches["fused"]["fused_dc"],
                   "fused_dc[int64] no edge function"),
        wide_entry("segment_fold[int64] n_pad_plus_1", "segment_fold.cu",
                   "fold_two_level.py:158",
                   payload_launches["fused"]["segment_fold"]
                   + payload_launches["composed"]["segment_fold"],
                   "segment_fold[int64] ids_mod_4096"),
        wide_entry("dc_gather[int64]", "dc_gather.cu", "dc_gather.py:62",
                   payload_launches["composed"]["dc_gather"]),
        wide_entry("segment_combine[int64]", "segment_combine.cu",
                   "segment_combine.py:122",
                   payload_launches["composed"]["segment_combine"]),
        wide_entry("fused_dc[int64,lanes=16]", "fused_dc.cu",
                   "fused_step.py:192",
                   payload_launches["fused_dc_lanes"] + serve_wide_lanes,
                   "fused_dc[int64,lanes=16] no edge function"),
        dict(row("fused_dc_interleave[int64,lanes=16]", "fused_dc.cu",
                 "fused_step.py:192",
                 payload_launches["fused_dc_interleave"] + serve_wide_lanes,
                 wide["fused_dc[int64,lanes=16]"]["interleave_err"],
                 dict(wide["fused_dc[int64,lanes=16]"]["controls"]
                      ["interleave_only"],
                      library_ms=wide["fused_dc[int64,lanes=16]"]
                      ["interleave_library_ms"],
                      plain_ms=wide["fused_dc[int64,lanes=16]"]
                      ["interleave_plain_ms"]),
                 wide["fused_dc[int64,lanes=16]"]["controls"]
                 ["interleave_only"]["bound_ms"])),
        wide_entry("dc_gather[int64,lanes=16]", "dc_gather.cu",
                   "dc_gather.py:62", payload_launches["dc_gather_lanes"]),
        wide_entry("segment_combine[int64,lanes=16]", "segment_combine.cu",
                   "segment_combine.py:122",
                   payload_launches["segment_combine_lanes"]),
    ]
    # the layout-free regime, launched by the dist phase's main path
    kernels += [dict(row(name, "fused_stream.cu", "fused_step.py:192",
                         rec["launches"], rec["max_abs_err"], rec,
                         rec["bound_ms"]), regime=rec["regime"],
                     controls=controls(rec))
                for name, rec in report["dist"]["kernels"].items()]
    for entry in kernels:
        check(entry["launches"] > 0, f"kernel {entry['name']} was not "
              "launched by its path")
    report["kernels"] = kernels
    report["elapsed_s"] = time.perf_counter() - started
    say("done", elapsed_s=report["elapsed_s"])
    Path(args.report).parent.mkdir(parents=True, exist_ok=True)
    Path(args.report).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)

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
           payloads, bit-exact; median times from CUDA events beside the
           bytes bound at 3.35 TB/s, the plain version's time, and for the
           fold ``Tensor.scatter_reduce_`` (a yardstick the port never calls).
  apps     BFS and SSSP from the highest-degree vertex, CC on the
           symmetrized graph and PageRank (10 iterations through
           ``run_fused``), hybrid mode on the default device, each against a
           host oracle; hybrid BFS again through the plain versions on the
           card, bit-exact with the kernel run; every kernel launched by the
           four app runs.

Then one JSON line with the kernels' numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that line, as does a machine where torch sees no CUDA device.  The full
record, the compilers' register and shared-memory reports included, is
also written to ``--report`` (default ``results/chip_smoke.json``).
"""
import argparse
import json
import subprocess
import sys
import time
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


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--report", default=str(ROOT / "results" /
                                            "chip_smoke.json"),
                    help="where to write the full record (JSON)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    import repro_torch as rt
    from repro_torch.core import monoid as M
    from repro_torch.graph import build_layout, rmat, symmetrize, to_scipy
    from repro_torch.kernels import _build
    from repro_torch.kernels.fold_block import (blocked_segment_fold,
                                                segment_fold)
    from repro_torch.kernels.fused_step import (add_weight,
                                                fused_scatter_fold,
                                                ref_fused_scatter_fold)
    from repro_torch.kernels.ops import FusedDCKernel

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
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
        return x.view(torch.int32) if x.dtype != torch.bool else x

    def max_abs_err(got, want, what):
        (ga, gt), (wa, wt) = got, want
        check(ga.dtype == wa.dtype and ga.shape == wa.shape, f"{what}: shape")
        same = bits(ga) == bits(wa)
        diff = (M.widen(ga).double() - M.widen(wa).double()).abs()
        err = float(torch.where(same, 0.0, diff).max()) if len(ga) else 0.0
        check(bool(same.all()), f"{what}: acc differs, max abs err {err}")
        check(torch.equal(gt, wt), f"{what}: touched differs")
        return err

    # ---------------- kernels ----------------
    kern = FusedDCKernel(L, "add", torch.float32, dev)
    edges = (kern.edge_src, kern.edge_valid, kern.edge_dst)
    fused_err = 0.0
    for monoid in MONOIDS:
        for dname, dtype in dtypes.items():
            table = payload(ns, dtype)
            tvalid = torch.rand(ns, generator=gen, device=dev) < 0.5
            got = fused_scatter_fold(table, tvalid, *edges, ns, monoid=monoid,
                                     part_off=kern.part_off, q=L.q)
            want = ref_fused_scatter_fold(M.REGISTRY[monoid](dtype), table,
                                          tvalid, *edges, ns)
            fused_err = max(fused_err, max_abs_err(
                got, want, f"fused_dc {monoid} {dname}"))
    table = payload(ns, torch.float32)
    tvalid = torch.rand(ns, generator=gen, device=dev) < 0.5
    w = kern.edge_w                        # the layout's SSSP weights
    fused_err = max(fused_err, max_abs_err(
        fused_scatter_fold(table, tvalid, *edges, ns, monoid="min",
                           part_off=kern.part_off, q=L.q,
                           apply_weight=add_weight, w=w),
        ref_fused_scatter_fold(M.min_(torch.float32), table, tvalid, *edges,
                               ns, apply_weight=add_weight, w=w),
        "fused_dc min float32 add_weight"))

    # timed at PageRank's step: f32 add, every source live
    pr_table = payload(ns, torch.float32)
    all_valid = torch.ones(ns, dtype=torch.bool, device=dev)
    fused_ms = median_ms(lambda: fused_scatter_fold(
        pr_table, all_valid, *edges, ns, monoid="add",
        part_off=kern.part_off, q=L.q), 20)
    fused_plain_ms = median_ms(lambda: ref_fused_scatter_fold(
        M.add(torch.float32), pr_table, all_valid, *edges, ns), 3)
    ne = L.num_edges
    fused_bytes = ns * (4 + 1) + ne * (4 + 1 + 4) + (L.k + 1) * 8 \
        + ns * (4 + 1)
    report["fused_dc"] = {
        "shape": {"table": ns, "edges": ne, "k": L.k, "q": L.q},
        "case": "add float32, all sources live", "ms": fused_ms,
        "plain_ms": fused_plain_ms, "bytes": fused_bytes,
        "bound_ms": bound_ms(fused_bytes), "max_abs_err": fused_err,
        "library_ms": None}
    say("kernels", name="fused_dc", **report["fused_dc"])

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
    fold_err, fold_rows = 0.0, {}
    for fold_ns, ids in ((4096, dst % 4096), (ns, dst)):
        for monoid in MONOIDS:
            for dname, dtype in dtypes.items():
                vals = payload(be, dtype)
                fold_err = max(fold_err, max_abs_err(
                    blocked_segment_fold(vals, valid, ids, fold_ns,
                                         monoid=monoid),
                    segment_fold(vals, valid, ids, fold_ns, monoid),
                    f"segment_fold {monoid} {dname} ns={fold_ns}"))
        # timed at SSSP's fold: f32 min
        vals = payload(be, torch.float32)
        masked = torch.where(valid, vals, float("inf"))
        ids64 = ids.to(torch.int64)
        lib_acc = torch.full((fold_ns,), float("inf"), device=dev)
        fold_bytes = be * (4 + 1 + 4) + fold_ns * (4 + 1)
        fold_rows[fold_ns] = {
            "shape": {"messages": be, "num_segments": fold_ns,
                      "bfs_superstep": fold_iter},
            "case": "min float32",
            "ms": median_ms(lambda: blocked_segment_fold(
                vals, valid, ids, fold_ns, monoid="min"), 20),
            "plain_ms": median_ms(lambda: segment_fold(
                vals, valid, ids, fold_ns, "min"), 3),
            "library_ms": median_ms(lambda: lib_acc.scatter_reduce_(
                0, ids64, masked, "amin", include_self=True), 20),
            "bytes": fold_bytes, "bound_ms": bound_ms(fold_bytes)}
        say("kernels", name="segment_fold", **fold_rows[fold_ns])
    report["segment_fold"] = {"max_abs_err": fold_err,
                              "by_num_segments": fold_rows}

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
            "launches": {k.name: k.launches - launches0[k.name]
                         for k in _build.KERNELS}}
        say("apps", app=name, **apps[name])

    def counts():
        return {k.name: k.launches for k in _build.KERNELS}

    _build.reset_launch_counts()
    c0 = counts()
    bfs_res, wall = timed(lambda: rt.bfs(L, src))
    app_record("bfs", bfs_res, wall, c0)
    check([s.sc_parts for s in bfs_res["stats"]] == [t[3] for t in sc_iters],
          "the timed fold's SC stream is not one the hybrid BFS run folded")
    c0 = counts()
    sssp_res, wall = timed(lambda: rt.sssp(L, src))
    app_record("sssp", sssp_res, wall, c0)
    c0 = counts()
    cc_res, wall = timed(lambda: rt.connected_components(S))
    app_record("cc", cc_res, wall, c0)
    c0 = counts()
    pr_res, wall = timed(lambda: rt.pagerank(L, iters=10))
    app_record("pagerank", pr_res, wall, c0)
    launches = counts()
    say("apps", launches_in_four_apps=launches)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the app runs")

    # host oracles
    t = time.perf_counter()
    d = csg.shortest_path(P, method="D", unweighted=True, indices=src)
    want_level = np.where(np.isinf(d), -1, d).astype(np.int32)
    check(np.array_equal(bfs_res["level"], want_level),
          "bfs levels differ from scipy")
    lv, par = bfs_res["level"], bfs_res["parent"]
    reached = lv > 0
    check(bool(np.all(lv[par[reached]] == lv[reached] - 1)),
          "bfs parents are not one level up")
    want_dist = csg.dijkstra(P, indices=src)
    fin = ~np.isinf(want_dist)
    check(np.array_equal(np.isinf(sssp_res["dist"]), ~fin),
          "sssp reaches other vertices than Dijkstra")
    sssp_rel = float(np.max(np.abs(sssp_res["dist"][fin] - want_dist[fin])
                            / np.maximum(want_dist[fin], 1e-30)))
    check(np.allclose(sssp_res["dist"][fin], want_dist[fin], rtol=1e-5,
                      atol=0), f"sssp differs from Dijkstra ({sssp_rel})")
    ncc, comp = csg.connected_components(to_scipy(gs), directed=False)
    least = np.full(ncc, g.n, np.int64)
    np.minimum.at(least, comp, np.arange(g.n))
    check(np.array_equal(cc_res["label"].astype(np.int64), least[comp]),
          "cc labels are not the least vertex id of each component")
    x = np.full(g.n, 1.0 / g.n)
    PT = P1.T.tocsr()
    outdeg = g.out_degrees()
    for _ in range(10):
        x = 0.15 / g.n + 0.85 * (PT @ np.where(
            outdeg > 0, x / np.maximum(outdeg, 1), 0.0))
    pr_l1 = float(np.abs(pr_res["pr"].astype(np.float64) - x).sum())
    check(pr_l1 <= 1e-5, f"pagerank L1 distance {pr_l1} > 1e-5")
    report["oracles"] = {"bfs_levels_equal": True, "sssp_max_rel_err":
                         sssp_rel, "cc_components": int(ncc),
                         "pagerank_l1": pr_l1,
                         "oracle_s": time.perf_counter() - t}
    say("apps", oracles=report["oracles"])

    # an engine's set-up (edge arrays to the card, the host check of the
    # fused kernel's precondition) is part of every app's wall time above
    plain, setup_s = timed(
        lambda: rt.Engine(L, rt.apps.bfs_program(), plain=True))
    say("apps", engine_setup_s=setup_s)
    plain_res, wall = timed(lambda: rt.bfs(L, src, engine=plain))
    check(np.array_equal(plain_res["level"], bfs_res["level"])
          and np.array_equal(plain_res["parent"], bfs_res["parent"]),
          "hybrid bfs through the plain versions differs from the kernels")
    say("apps", app="bfs_plain_versions", wall_s=wall, bit_exact=True)
    report["apps"] = apps
    report["engine_setup_s"] = setup_s

    kernels = [
        {"name": "fused_dc", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_dc.cu",
         "replaces": "src/repro/kernels/fused_step.py:192",
         "launches": launches["fused_dc"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": report["fused_dc"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "segment_fold", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_fold.cu",
         "replaces": "src/repro/kernels/fold_two_level.py:158",
         "launches": launches["segment_fold"], "max_abs_err": fold_err,
         "ms": fold_rows[ns]["ms"], "plain_ms": fold_rows[ns]["plain_ms"],
         "bound_ms": fold_rows[ns]["bound_ms"], "bound_by": "bytes",
         "library_ms": fold_rows[ns]["library_ms"]},
    ]
    report["kernels"] = kernels
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

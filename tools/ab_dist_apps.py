#!/usr/bin/env python3
"""Time the distributed engine's apps in ``dc`` mode against the same apps
run by another checkout's package, in turns, in one process on one NVIDIA
GPU.

    python3 tools/ab_dist_apps.py --baseline DIR [--scale 22] [--seed 0]
        [--rounds 2] [--report results/ab_dist_apps.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Its ``src/repro_torch`` is loaded
beside this tree's under another module name (the package imports itself
only relatively), and builds its own kernels.  The inputs are
``chip_smoke.py``'s: Graph500 RMAT at ``--scale`` from ``--seed``, its
k=128, edge_tile=256 layout and the symmetrized graph's (for CC), each
sharded for one rank.  One NCCL process group of world size 1 (a
``tcp://localhost`` store on a free port) serves both packages.

Each package builds one ``DistEngine`` an app (BFS, SSSP and CC from the
graph's largest out-degree vertex, PageRank for 10 iterations through
``run``), all in mode ``dc``, and runs each app once untimed (the first
run in the process pays the collectives' and kernels' first use, and its
walls are kept apart as ``first``).  Then, ``--rounds`` times, each app runs
in the order old, new, new, old.  For each run the record holds the sum of
the iterations' ``wall_s`` (host clock) and the app call's wall.  The two
packages' answers must agree bit for bit (PageRank within L1 1e-6) in every
run.  One line per app is printed, the card's name and power limit first,
and the record goes to ``--report``.
"""
import argparse
import datetime
import importlib
import importlib.util
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def load_package(src: Path, name: str):
    """The package at ``src`` (a ``repro_torch`` directory) as module
    ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, src / "__init__.py", submodule_search_locations=[str(src)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--report", default=str(ROOT / "results" /
                                            "ab_dist_apps.json"))
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("ab_dist_apps: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    pkgs = {"old": load_package(Path(args.baseline).resolve()
                                / "src/repro_torch", "repro_torch_baseline"),
            "new": load_package(ROOT / "src/repro_torch", "repro_torch")}
    for pkg in pkgs.values():
        importlib.import_module(f"{pkg.__name__}.kernels._build").build_all()
    new = pkgs["new"]
    from repro_torch.graph.shard import shard_layout

    t0 = time.perf_counter()
    g = new.graph.rmat(args.scale, 16, seed=args.seed, weighted=True)
    L = new.graph.build_layout(g, k=128, edge_tile=256, msg_tile=128)
    S = new.graph.build_layout(new.graph.symmetrize(g), k=128,
                               edge_tile=256, msg_tile=128)
    SL, SS = shard_layout(L, 1), shard_layout(S, 1)
    src = int(np.argmax(g.out_degrees()))
    report = {"nvidia_smi": smi, "args": vars(args),
              "inputs_s": time.perf_counter() - t0, "apps": {}}

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        runs = {}
        for side, pkg in pkgs.items():
            de = importlib.import_module(f"{pkg.__name__}.dist.engine")
            mesh = importlib.import_module(f"{pkg.__name__}.dist").make_mesh(
                "cuda")

            def engine(sl, program, de=de, mesh=mesh):
                return de.DistEngine(sl, program, mesh, mode="dc")
            runs[side] = {
                "bfs": (lambda e, p=pkg: p.bfs(L, src, engine=e),
                        engine(SL, pkg.apps.bfs_program()), ("level",
                                                             "parent")),
                "sssp": (lambda e, p=pkg: p.sssp(L, src, engine=e),
                         engine(SL, pkg.apps.sssp_program()), ("dist",)),
                "cc": (lambda e, p=pkg: p.connected_components(S, engine=e),
                       engine(SS, pkg.apps.cc_program()), ("label",)),
                "pagerank": (lambda e, p=pkg: p.pagerank(
                    L, iters=10, engine=e, fused=False),
                    engine(SL, pkg.apps.pagerank_program(L.n)), ("pr",))}

        def run(side, app):
            fn, eng, keys = runs[side][app]
            t = time.perf_counter()
            res = fn(eng)
            wall = time.perf_counter() - t
            it_ms = sum(s["wall_s"] for s in res["stats"]) * 1e3
            return {key: res[key] for key in keys}, it_ms, wall

        def check(app, a, b):
            for key in a:
                if app == "pagerank":
                    err = float(np.abs(a[key].astype(np.float64)
                                       - b[key]).sum())
                    ok = err <= 1e-6
                else:
                    ok = np.array_equal(a[key], b[key])
                if not ok:
                    raise SystemExit(f"ab_dist_apps: {app} {key} differs "
                                     "between the two packages")

        for app in ("bfs", "sssp", "cc", "pagerank"):
            rec = report["apps"][app] = {"first": {}, "iter_ms": {},
                                         "wall_s": {}}
            want = None
            for side in ("old", "new"):
                out, it_ms, wall = run(side, app)
                rec["first"][side] = {"iter_ms": it_ms, "wall_s": wall}
                want = out if want is None else want
                check(app, out, want)
            for side in ("old", "new"):
                rec["iter_ms"][side], rec["wall_s"][side] = [], []
            for _ in range(args.rounds):
                for side in ("old", "new", "new", "old"):
                    out, it_ms, wall = run(side, app)
                    check(app, out, want)
                    rec["iter_ms"][side].append(it_ms)
                    rec["wall_s"][side].append(wall)
            rec["median_iter_ms"] = {side: float(np.median(v)) for side, v
                                     in rec["iter_ms"].items()}
            print(json.dumps({"app": app, **rec}), flush=True)
    finally:
        dist.destroy_process_group()
    Path(args.report).parent.mkdir(parents=True, exist_ok=True)
    Path(args.report).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

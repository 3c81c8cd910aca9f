#!/usr/bin/env python3
"""Time the port's ``spmv_block`` and ``segment_fold`` CUDA kernels against
the same two kernels built from another checkout, in turns, on one NVIDIA GPU.

    python3 tools/ab_torch_kernels.py --baseline DIR [--scale 22] [--seed 0]
        [--rounds 2] [--report results/ab_torch_kernels.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``); its ``src/repro_torch/csrc/
spmv_block.cu`` and ``segment_fold.cu`` are built beside this tree's, with
the C interfaces they had there.  The inputs are ``chip_smoke.py``'s: Graph500
RMAT at ``--scale`` from ``--seed`` with its k=128, edge_tile=256 layout; the
fold's main stream is the largest SC stream a hybrid BFS from the
highest-degree vertex folds, captured from the engine.

Rows, each timed ``--rounds`` times in the order old, new, new, old:

  spmv      weighted and unweighted: the baseline kernel and this tree's;
            the CSR product of ``torch.sparse_csr_tensor`` as the yardstick
            (weighted only).  Weighted, also this tree's kernel on the same
            edges with destinations drawn uniformly, which have no hub: what
            the hubs cost.  With the layout's hub statistics: each
            destination partition's largest in-degree and edge count.  (To
            time another variant of a kernel, build it from a checkout of
            its own and pass that as the baseline.)
  atomics   this tree's ``segment_combine`` (unchanged here) on the layout's
            edges in f32 add, i32 add and f32 min: a float add into shared
            memory is a compare-and-swap loop, the others one instruction.
  fold      f32 min on the main stream into n_pad + 1 segments, on the same
            stream with ids mod 4096, and on the tuner's two shapes: ``fold``
            (the layout's edges into n_pad + 1 segments by destination) and
            ``fold2`` (as many sorted ids into 6,145 segments);
            beside ``scatter_reduce_`` onto a filled accumulator
            (``library_ms``) and ``torch.full`` + ``scatter_reduce_``
            (``library_fill_ms``).  Each kernel also through its bare C
            entry (``old_c``, ``new_c``: the outputs allocated and the
            arguments converted once, outside the loop), so that the host
            time splits into the Python wrapper and the C entry's launch.

Each time is given four ways, by ``chip_smoke.kernel_times``: ``ms``, the
median of single calls each between two CUDA events; ``device_ms``, CUDA
events around ``--reps`` launches queued behind a ``torch.cuda._sleep`` so
that the card runs them back to back, over the count; ``call_ms``, the host
clock around the same count of calls ending in a synchronize, over the count
(host included); ``host_ms``, that clock stopped before the synchronize.
Every output of the new kernels is checked bit-exact against the old ones
on integer payloads.  The record goes to ``--report``; one line per row is
printed, and the card's name and power limit first.
"""
import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import bound_ms, kernel_times  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--report", default=str(ROOT / "results" /
                                            "ab_torch_kernels.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ab_torch_kernels: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.graph import build_layout, rmat
    from repro_torch.kernels import _build
    from repro_torch.kernels.fold_block import segment_fold_cuda
    from repro_torch.kernels.ops import GatherKernel, SpmvKernel
    from repro_torch.kernels.segment_combine import segment_combine_cuda
    from repro_torch.kernels.spmv_block import MAX_CHUNK, spmv_block_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"nvidia_smi": smi, "args": vars(args), "rows": []}

    # the baseline's C interfaces are those of the parent of the commit
    # that added this tool
    base_csrc = Path(args.baseline).resolve() / "src/repro_torch/csrc"
    P, I64, I32 = _build.P, _build.I64, _build.I32
    old_spmv = _build.CudaKernel("spmv_block", str(base_csrc / "spmv_block.cu"),
                                 (P, P, P, P, P, P, P, I32, I32, I32, I32, I32,
                                  P, P))
    old_fold = _build.CudaKernel("segment_fold",
                                 str(base_csrc / "segment_fold.cu"),
                                 (P, P, P, I64, I64, I32, I32, P, P, P))
    started = [k.start_build() for k in (old_spmv, old_fold)]
    _build.build_all()
    for k, st in zip((old_spmv, old_fold), started):
        k.finish_build(st)
        k.lib()

    def stream():
        return _build.stream_handle(dev)

    def in_turns(fns, reps):
        """{name: [timings, ...]}: the variants in order, then reversed, for
        each round."""
        out = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name in list(fns) + list(fns)[::-1]:
                out[name].append(kernel_times(fns[name], reps))
        return out

    def emit(row):
        report["rows"].append(row)
        print(json.dumps(row), flush=True)

    # ---------------- inputs ----------------
    t0 = time.perf_counter()
    g = rmat(args.scale, 16, seed=args.seed, weighted=True)
    L = build_layout(g, k=128, edge_tile=256, msg_tile=128)
    report["graph_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def payload(n):
        return torch.randint(-64, 64, (n,), generator=gen,
                             device=dev).to(torch.float32)

    # ---------------- spmv ----------------
    vk = SpmvKernel(L, dev)
    k, q, et, ne, nt = L.k, L.q, L.edge_tile, L.num_edges, L.num_edge_tiles
    x = payload(L.n_pad).view(k, q)
    edges = (vk.edge_src_local, vk.edge_dst_local, vk.edge_valid)

    def old_spmv_fn(w, y):
        old_spmv.launch(x.data_ptr(), *(a.data_ptr() for a in edges),
                        w.data_ptr() if w is not None else None,
                        vk.tile_src_part.data_ptr(),
                        vk.part_tile_off.data_ptr(), k, q, et, min(q, 40960),
                        int(w is not None), y.data_ptr(), stream())
        return y

    def new_spmv_fn(w):
        return spmv_block_cuda(x, *edges, w, vk.tile_src_part,
                               vk.part_tile_off, k=k, q=q, edge_tile=et,
                               weighted=w is not None)

    valid_np = L.edge_valid.astype(bool)
    src_np = (np.repeat(L.tile_src_part.astype(np.int64), et) * q
              + L.edge_src_local)[valid_np]
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([L.edge_dst[valid_np].astype(np.int64),
                                       src_np])),
            torch.from_numpy(L.edge_w[valid_np]), (L.n_pad, L.n_pad)).to(dev)
        at_csr = coo.coalesce().to_sparse_csr()
    del coo, src_np, valid_np
    xv = x.reshape(-1, 1)
    w_int = payload(ne)
    uniform_dst = torch.randint(0, q, (ne,), generator=gen, device=dev).to(
        torch.int32)
    indeg = np.bincount(L.edge_dst[L.edge_valid.astype(bool)],
                        minlength=L.n_pad + 1)[:L.n_pad].reshape(k, q)
    part_edges = indeg.sum(1)
    hub = indeg.max(1)
    emit({"row": "hubs", "largest_in_degree": int(hub.max()),
          "its_partition": int(hub.argmax()),
          "its_partition_edges": int(part_edges[hub.argmax()]),
          "median_partition_largest_in_degree": float(np.median(hub)),
          "partition_edges_mean": float(part_edges.mean()),
          "partition_edges_max": int(part_edges.max()),
          "partition_with_most_edges": int(part_edges.argmax())})
    for weighted in (True, False):
        w_time = vk.edge_w if weighted else None
        w_chk = w_int if weighted else None
        y_old = torch.empty((k, q), device=dev)
        want = old_spmv_fn(w_chk, y_old).clone()
        check_equal(new_spmv_fn(w_chk), want, f"spmv weighted={weighted}")
        fns = {"old": lambda: old_spmv_fn(w_time, y_old),
               "new": lambda: new_spmv_fn(w_time)}
        if weighted:
            fns["csr_library"] = lambda: at_csr @ xv
            fns["new_uniform_dst"] = lambda: spmv_block_cuda(
                x, edges[0], uniform_dst, edges[2], w_time, vk.tile_src_part,
                vk.part_tile_off, k=k, q=q, edge_tile=et, weighted=True)
        nbytes = ne * (4 + 4 + 1 + (4 if weighted else 0)) + nt * 4 \
            + (k + 1) * 8 + 2 * L.n_pad * 4
        emit({"row": "spmv", "weighted": weighted,
              "shape": {"edges": ne, "edge_tiles": nt, "k": k, "q": q,
                        "chunk": min(q, MAX_CHUNK)},
              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "times": in_turns(fns, args.reps)})
    gk = GatherKernel(L, "add", torch.float32, dev)
    all_parts = torch.ones(k, dtype=torch.bool, device=dev)
    fns = {}
    for name, dtype, monoid in (("f32_add", torch.float32, "add"),
                                ("i32_add", torch.int32, "add"),
                                ("f32_min", torch.float32, "min")):
        vals = payload(ne).to(dtype)
        fns[name] = (lambda vals=vals, monoid=monoid: segment_combine_cuda(
            vals, edges[2], gk.edge_dst_local, gk.tile_src_part,
            gk.part_tile_off, all_parts, k=k, q=q, edge_tile=et,
            monoid=monoid))
    emit({"row": "atomics", "kernel": "segment_combine",
          "times": in_turns(fns, args.reps)})
    del at_csr, w_int, vk, gk, x, xv, edges, uniform_dst, fns

    # ---------------- fold ----------------
    eng = rt.Engine(L, rt.apps.bfs_program())
    folds = []
    inner = eng._fold

    def capture(vals, valid, ids, ns):
        folds.append((vals, valid, ids))
        return inner(vals, valid, ids, ns)

    eng._fold = capture
    rt.bfs(L, int(np.argmax(g.out_degrees())), engine=eng)
    vals_i, valid, ids = max(folds, key=lambda f: f[0].shape[0])
    del folds, eng
    n = ids.shape[0]
    ns2 = 4096 + 2048 + 1
    rng = np.random.default_rng(0)
    edge_valid = torch.from_numpy(L.edge_valid.astype(bool)).to(dev)
    ids2 = torch.from_numpy(np.sort(rng.integers(0, ns2 - 1, ne)).astype(
        np.int32)).to(dev)
    ids2 = torch.where(edge_valid, ids2, ns2 - 1).to(torch.int32)
    edge_dst = torch.from_numpy(L.edge_dst.astype(np.int32)).to(dev)
    cases = (("main", L.n_pad + 1, payload(n), valid, ids),
             ("mod4096", 4096, payload(n), valid, ids % 4096),
             ("tuner_fold", L.n_pad + 1, payload(ne), edge_valid, edge_dst),
             ("fold2", ns2, payload(ne), edge_valid, ids2))
    for name, ns, vals, ok, fids in cases:
        fids = fids.to(torch.int32).contiguous()

        def old_args(monoid, v, acc, touched):
            return (v.data_ptr(), ok.data_ptr(), fids.data_ptr(), v.shape[0],
                    ns, _build.MONOID_CODES[monoid],
                    _build.dtype_code(v.dtype), acc.data_ptr(),
                    touched.data_ptr(), stream())

        def old_fold_fn(monoid="min", v=vals):
            acc = torch.empty(ns, dtype=v.dtype, device=dev)
            touched = torch.empty(ns, dtype=torch.bool, device=dev)
            old_fold.launch(*old_args(monoid, v, acc, touched))
            return acc, touched

        for monoid in ("add", "min", "max"):
            check_equal(segment_fold_cuda(vals, ok, fids, ns, monoid),
                        old_fold_fn(monoid), f"fold {name} {monoid}")
        masked = torch.where(ok, vals, float("inf"))
        ids64 = fids.to(torch.int64)
        lib_acc = torch.full((ns,), float("inf"), device=dev)
        out_acc, out_touched = old_fold_fn()
        old_c = c_call(old_fold, old_args("min", vals, out_acc, out_touched))
        new_c = c_call(_build.SEGMENT_FOLD, old_args(
            "min", vals, out_acc, out_touched)[:-1]
            + (torch.cuda.current_device(), stream()))
        fns = {"old": old_fold_fn,
               "new": lambda: segment_fold_cuda(vals, ok, fids, ns, "min"),
               "old_c": old_c, "new_c": new_c,
               "library": lambda: lib_acc.scatter_reduce_(
                   0, ids64, masked, "amin", include_self=True),
               "library_fill": lambda: torch.full(
                   (ns,), float("inf"), device=dev).scatter_reduce_(
                       0, ids64, masked, "amin", include_self=True)}
        nbytes = vals.shape[0] * (4 + 1 + 4) + ns * (4 + 1)
        emit({"row": "fold", "case": name, "monoid": "min float32",
              "shape": {"messages": int(vals.shape[0]),
                        "num_segments": ns},
              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "times": in_turns(fns, args.reps)})

    Path(args.report).parent.mkdir(parents=True, exist_ok=True)
    Path(args.report).write_text(json.dumps(report, indent=1))
    return 0


def c_call(kernel, args):
    """A call of ``kernel``'s bare C entry on ``args``, converted to C
    once."""
    fn = kernel._fn
    cargs = [t(a) for t, a in zip(kernel.argtypes, args)]
    if fn(*cargs) != 0:
        raise SystemExit(f"ab_torch_kernels: {kernel.name} failed")
    return lambda: fn(*cargs)


def check_equal(got, want, what):
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        a8 = a.view(torch.uint8) if a.dtype != torch.bool else a
        b8 = b.view(torch.uint8) if b.dtype != torch.bool else b
        if not torch.equal(a8, b8):
            raise SystemExit(f"ab_torch_kernels: {what}: the new kernel "
                             "differs from the baseline")


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's tile kernels (``fused_dc``, ``segment_combine``,
``spmv_block``), ``dc_gather`` and ``segment_fold`` against the same kernels
built from another checkout, in turns, on one NVIDIA GPU.

    python3 tools/ab_torch_kernels.py --baseline DIR [--scale 22] [--seed 0]
        [--rounds 2] [--rows spmv,combine,...] [--report
        results/ab_torch_kernels.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``); its ``src/repro_torch/csrc/
fused_dc.cu``, ``segment_combine.cu``, ``spmv_block.cu``, ``dc_gather.cu``
and ``segment_fold.cu`` are built beside this tree's.  Each baseline kernel
is called through the C interface its own source declares, which must be
one this tool knows: this tree's; for ``fused_stream``, the stream regime
alone, before its partitioned regime; for ``fused_dc``, the edge-range form it
had before it read the tile form (the global ``idx`` and ``dst`` and the
partitions' edge offsets, built here once on the card from the layout); for
``dc_gather``, the slot form it had before its staged regime (no pieces),
and its staged form before 8-byte words (no word width).  Any other
interface is refused.  To time a variant of a kernel, build it in another
checkout and pass that.  The inputs are ``chip_smoke.py``'s: Graph500 RMAT
at ``--scale`` from ``--seed`` with its k=128, edge_tile=256 layout.

Rows, each timed ``--rounds`` times in the order old, new, ..., new, old:

  hubs      the layout's hub statistics: each destination partition's
            largest in-degree and edge count.
  spmv      weighted and unweighted: the baseline kernel and this tree's;
            the CSR product of ``torch.sparse_csr_tensor`` as the yardstick
            (weighted only), and this tree's kernel on the same edges with
            destinations drawn uniformly, which have no hub.
  combine   ``segment_combine`` on the layout's edges, every source
            partition active, in f32 add, i32 add, f32 min and u32 min (a
            float add into shared memory is a compare-and-swap loop, the
            others one instruction); this tree's kernel also through plain
            loads (arrays off a 16-byte boundary).
  fused     ``fused_dc`` at PageRank's step (every source live) in the same
            four cases and at SSSP's (f32 min with ``add_weight``), also
            through plain loads.
  gather    ``dc_gather`` at PageRank's composed step (f32 add, the
            layout's msg_tile=128 slots), every source active and half of
            them: the baseline kernel, this tree's through the pieces
            ``ScatterKernel`` binds (the staged regime), and this tree's
            without them (the L2 regime), and a baseline of this tree's
            interface without them too; each row names the regimes this
            tree's calls took.
  lanes     ``fused_dc``'s lane form at B = 16: PageRank's step (f32 add,
            every source live) and SSSP-with-parents' (the 8-byte min with
            ``add_weight_to_key``): the baseline's lane form (its tile form
            a lane on ``blockIdx.y``, as before the edge copy, or this
            tree's), this tree's, and as controls this tree's two launches
            each alone (the interleaving, the fold over the edge copy) and
            16 single-lane launches.
  gather8   ``dc_gather`` on 8-byte words (SSSP-with-parents' composed
            step), single lane and B = 16: the baseline kernel with this
            tree's pieces (before the 8-byte staged regime it reads them
            through L2), this tree's (staged in half rows), this tree's
            without pieces (L2), and ``torch.index_select`` of x over the
            slots' sources.
  flat      the layout-free ``fused_dc`` (``fused_stream``) on the
            received bins of ``shard_layout(L, 1)`` (one rank), as the dist
            engine calls it: f32 add (PageRank) and the 8-byte min with
            ``add_weight_to_key`` (SSSP-with-parents), every slot live, and
            u32 min (BFS) with half, a tenth and a hundredth of the slots
            live: the baseline kernel
            (the stream regime only, before the partitioned one, or this
            tree's interface over the same ranges), this tree's
            partitioned regime over the engine's ranges
            (``part_ranges``), and this tree's stream regime.
  fold      ``segment_fold`` on ``chip_smoke.py``'s three streams: 332,010
            messages (its SC stream at scale 22) whose ids are the
            destinations of edges drawn at random, into n_pad + 1 and
            into 4096 segments, and the tuner's ``fold2`` (every edge of
            the layout, sorted ids, into 6,145); f32 min, and the 8-byte
            min on the n_pad + 1 stream.

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
import ctypes
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import bound_ms, kernel_times  # noqa: E402

# fused_dc's C entry before it read the tile form, and its argument types
FUSED_EDGE_RANGE = ("table", "table_valid", "table_len", "idx", "edge_valid",
                    "dst", "w", "part_off", "k", "q", "chunk", "num_segments",
                    "monoid", "dtype", "edge_fn", "acc", "touched", "stream")
# dc_gather's C entry before the staged regime (one thread per slot)
GATHER_SLOTS = ("x", "active", "png_src_local", "png_valid", "png_tile_part",
                "nm", "k", "q", "msg_tile", "ident_bits", "out", "stream")
# dc_gather's C entry with the staged regime, before 8-byte words
GATHER_FOUR_BYTE = ("x", "active", "png_src_local", "png_valid",
                    "png_tile_part", "piece_tiles", "n_pieces", "nm", "k",
                    "q", "msg_tile", "ident_bits", "out", "device", "regime",
                    "stream")
# fused_dc's lane form before the edge copy: the tile form, a lane a
# blockIdx.y
FUSED_TILE_LANES = ("table", "table_valid", "table_len", "table_stride",
                    "src_local", "dst_local", "valid", "w", "tile_src_part",
                    "part_tile_off", "k", "q", "edge_tile", "chunk",
                    "num_segments", "lanes", "out_stride", "monoid", "dtype",
                    "edge_fn", "acc", "touched", "stream")

# fused_stream's C entry before the partitioned regime (no part_off)
STREAM_ONLY = ("table", "table_valid", "table_len", "idx", "edge_valid",
               "dst", "w", "n", "num_segments", "monoid", "dtype", "edge_fn",
               "acc", "touched", "device", "stream")


ROWS = "spmv,combine,fused,lanes,gather,gather8,flat,fold"


def c_params(source: Path, name: str) -> tuple:
    """The parameter names of ``extern "C" int name(...)`` in ``source``."""
    found = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                      source.read_text())
    if found is None:
        raise SystemExit(f"ab_torch_kernels: {source} declares no C entry "
                         f"{name}")
    return tuple(re.split(r"[\s*]+", p.strip())[-1]
                 for p in found.group(1).split(","))


def baseline_kernel(kern, base_csrc: Path, shares=None):
    """``(kernel, interface)``: ``kern``'s C entry built from the baseline's
    source (through ``shares``' library, for a second entry of a source),
    bound with the argument types of the interface that source declares:
    ``"this"`` (this tree's), ``"edge_range"`` (``fused_dc`` before the tile
    form), ``"slots"`` (``dc_gather`` before its staged regime),
    ``"four_byte"`` (``dc_gather`` staged, before 8-byte words),
    ``"tile_lanes"`` (``fused_dc_lanes`` before the edge copy) or
    ``"stream_only"`` (``fused_stream`` before its partitioned regime).
    Refuses any other."""
    from repro_torch.kernels import _build
    src = base_csrc / kern.source.name
    params = c_params(src, kern.name)
    if params == c_params(kern.source, kern.name):
        return _build.CudaKernel(kern.name, str(src), kern.argtypes,
                                 shares=shares), "this"
    if kern.name == "fused_dc_lanes" and params == FUSED_TILE_LANES:
        P, I64, I32 = _build.P, _build.I64, _build.I32
        return _build.CudaKernel(kern.name, str(src), (
            P, P, I64, I64, P, P, P, P, P, P, I32, I32, I32, I32, I64, I32,
            I64, I32, I32, I32, P, P, P), shares=shares), "tile_lanes"
    if kern.name == "fused_stream" and params == STREAM_ONLY:
        P, I64, I32 = _build.P, _build.I64, _build.I32
        return _build.CudaKernel(kern.name, str(src), (
            P, P, I64, P, P, P, P, I64, I64, I32, I32, I32, P, P, I32, P),
            shares=shares), "stream_only"
    if kern.name == "fused_dc" and params == FUSED_EDGE_RANGE:
        P, I64, I32 = _build.P, _build.I64, _build.I32
        return _build.CudaKernel(kern.name, str(src), (
            P, P, I64, P, P, P, P, P, I32, I32, I32, I64, I32, I32, I32, P,
            P, P)), "edge_range"
    if kern.name == "dc_gather" and params == GATHER_SLOTS:
        P, I64, I32 = _build.P, _build.I64, _build.I32
        return _build.CudaKernel(kern.name, str(src), (
            P, P, P, P, P, I64, I32, I32, I32, ctypes.c_uint, P, P)), "slots"
    if kern.name == "dc_gather" and params == GATHER_FOUR_BYTE:
        P, I64, I32 = _build.P, _build.I64, _build.I32
        return _build.CudaKernel(kern.name, str(src), (
            P, P, P, P, P, P, I64, I64, I32, I32, I32, ctypes.c_uint, P, I32,
            ctypes.POINTER(ctypes.c_int), P)), "four_byte"
    raise SystemExit(f"ab_torch_kernels: the baseline's {kern.name} takes "
                     f"({', '.join(params)}), an interface this tool does not "
                     "know")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rows", default=ROWS,
                    help="the rows to time, comma-separated (default all: "
                         f"{ROWS})")
    ap.add_argument("--report", default=str(ROOT / "results" /
                                            "ab_torch_kernels.json"))
    args = ap.parse_args()
    rows = set(args.rows.split(","))
    if not rows <= set(ROWS.split(",")):
        raise SystemExit(f"ab_torch_kernels: unknown rows "
                         f"{sorted(rows - set(ROWS.split(',')))}")

    import torch
    if not torch.cuda.is_available():
        print("ab_torch_kernels: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph import build_layout, rmat
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_step import (EdgeTiles, _EDGE_FNS,
                                                add_weight,
                                                add_weight_to_key,
                                                build_lane_edges,
                                                fused_dc_cuda, global_edges,
                                                lane_group, lane_width,
                                                max_chunk)
    from repro_torch.backend.tuning import FOLD_CAP
    from repro_torch.kernels.dc_gather import dc_gather_cuda, identity_bits
    from repro_torch.kernels.fold_block import segment_fold_cuda
    from repro_torch.kernels.ops import (FusedDCKernel, GatherKernel,
                                         ScatterKernel, SpmvKernel)
    from repro_torch.kernels.segment_combine import segment_combine_cuda
    from repro_torch.kernels.spmv_block import MAX_CHUNK, spmv_block_cuda

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"nvidia_smi": smi, "args": vars(args), "rows": []}

    base_csrc = Path(args.baseline).resolve() / "src/repro_torch/csrc"
    old, iface = {}, {}
    for key, kern in (("spmv", _build.SPMV_BLOCK),
                      ("combine", _build.SEGMENT_COMBINE),
                      ("fused", _build.FUSED_DC),
                      ("gather", _build.DC_GATHER),
                      ("flat", _build.FUSED_STREAM),
                      ("fold", _build.SEGMENT_FOLD)):
        old[key], iface[key] = baseline_kernel(kern, base_csrc)
    old["lanes"], iface["lanes"] = baseline_kernel(
        _build.FUSED_DC_LANES, base_csrc, shares=old["fused"])
    if iface["lanes"] == "this":
        old["interleave"], _ = baseline_kernel(
            _build.FUSED_DC_INTERLEAVE, base_csrc, shares=old["fused"])
    if iface["gather"] == "this":
        old["gather_lanes"], _ = baseline_kernel(
            _build.DC_GATHER_LANES, base_csrc, shares=old["gather"])
    report["baseline_interfaces"] = iface
    # a baseline source equal to this tree's builds one library, once
    ours = {k.library_path() for k in _build.KERNELS}
    started = [None if k.library_path() in ours else k.start_build()
               for k in old.values()]
    _build.build_all()
    for k, st in zip(old.values(), started):
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

    def payload(n, dtype=torch.float32):
        lo = 0 if dtype == torch.uint32 else -64
        x = torch.randint(lo, 64, (n,), generator=gen, device=dev)
        if dtype == torch.uint32:
            return x.to(torch.int32).view(torch.uint32)
        return x.to(dtype)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t)
        return buf[1:]

    # ---------------- spmv ----------------
    vk = SpmvKernel(L, dev)
    k, q, et, ne, nt = L.k, L.q, L.edge_tile, L.num_edges, L.num_edge_tiles
    x = payload(L.n_pad).view(k, q)
    edges = (vk.edge_src_local, vk.edge_dst_local, vk.edge_valid)

    def old_spmv_fn(w, y):
        old["spmv"].launch(x.data_ptr(), *(a.data_ptr() for a in edges),
                           w.data_ptr() if w is not None else None,
                           vk.tile_src_part.data_ptr(),
                           vk.part_tile_off.data_ptr(), k, q, et,
                           min(q, MAX_CHUNK), int(w is not None),
                           y.data_ptr(), stream())
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
    del coo, src_np
    xv = x.reshape(-1, 1)
    w_int = payload(ne)
    uniform_dst = torch.randint(0, q, (ne,), generator=gen, device=dev).to(
        torch.int32)
    indeg = np.bincount(L.edge_dst[valid_np],
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
    del valid_np
    for weighted in (True, False) if "spmv" in rows else ():
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
    del at_csr, vk, x, xv, uniform_dst

    # ---------------- combine ----------------
    gk = GatherKernel(L, "add", torch.float32, dev)
    all_parts = torch.ones(k, dtype=torch.bool, device=dev)
    edge_valid = torch.from_numpy(L.edge_valid).to(dev)
    dtypes = {"f32": torch.float32, "i32": torch.int32, "u32": torch.uint32}
    cases = (("f32_add", "f32", "add"), ("i32_add", "i32", "add"),
             ("f32_min", "f32", "min"), ("u32_min", "u32", "min"))

    def combine_args(vals, monoid, view=lambda a: a):
        acc = torch.empty((k, q), dtype=vals.dtype, device=dev)
        touched = torch.empty((k, q), dtype=torch.bool, device=dev)
        return (view(vals).data_ptr(), view(edge_valid).data_ptr(),
                view(gk.edge_dst_local).data_ptr(),
                gk.tile_src_part.data_ptr(), gk.part_tile_off.data_ptr(),
                all_parts.data_ptr(), k, q, et, min(q, MAX_CHUNK),
                _build.MONOID_CODES[monoid],
                _build.dtype_code(vals.dtype, monoid),
                acc.data_ptr(), touched.data_ptr(), stream()), (acc, touched)

    def run_c(kern, args_out):
        args, out = args_out
        kern.launch(*args)
        return out

    nbytes = ne * (4 + 1 + 4) + nt * 4 + (k + 1) * 8 + k + L.n_pad * (4 + 1)
    for name, dname, monoid in cases if "combine" in rows else ():
        vals = payload(ne, dtypes[dname])
        check_equal(segment_combine_cuda(
            vals, edge_valid, gk.edge_dst_local, gk.tile_src_part,
            gk.part_tile_off, all_parts, k=k, q=q, edge_tile=et,
            monoid=monoid), run_c(old["combine"], combine_args(vals, monoid)),
            f"combine {name}")
        old_call = combine_args(vals, monoid)
        fns = {"old": lambda a=old_call: run_c(old["combine"], a),
               "new": lambda v=vals, m=monoid: segment_combine_cuda(
                   v, edge_valid, gk.edge_dst_local, gk.tile_src_part,
                   gk.part_tile_off, all_parts, k=k, q=q, edge_tile=et,
                   monoid=m),
               "new_plain_loads": lambda a=combine_args(
                   vals, monoid, unaligned): run_c(_build.SEGMENT_COMBINE, a)}
        emit({"row": "combine", "case": name,
              "shape": {"edges": ne, "edge_tiles": nt, "k": k, "q": q},
              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "times": in_turns(fns, args.reps)})
        del fns, old_call
    del gk

    # ---------------- fused ----------------
    fk = FusedDCKernel(L, "add", torch.float32, dev, apply_weight=add_weight)
    tiles = fk.tiles
    if iface["fused"] == "edge_range":
        idx, dst = global_edges(fk.tile_src_part, fk.tile_dst_part,
                                fk.edge_src_local, fk.edge_dst_local,
                                edge_valid, q=q, edge_tile=et, n_pad=L.n_pad)
        part_off = torch.from_numpy(np.asarray(L.blk_off[::k], np.int64)).to(
            dev)
    ns = L.n_pad + 1
    all_live = torch.ones(ns, dtype=torch.bool, device=dev)
    plain_tiles = EdgeTiles(unaligned(tiles.edge_src_local),
                            unaligned(tiles.edge_dst_local), *tiles[2:])
    plain_valid, plain_w = unaligned(edge_valid), unaligned(fk.edge_w)

    def old_fused(table, monoid, fn, w):
        if iface["fused"] == "this":
            return new_fused(table, monoid, fn, w)
        acc = torch.empty(ns, dtype=table.dtype, device=dev)
        touched = torch.empty(ns, dtype=torch.bool, device=dev)
        args = (table.data_ptr(), all_live.data_ptr(), ns, idx.data_ptr(),
                edge_valid.data_ptr(), dst.data_ptr(),
                w.data_ptr() if fn else None, part_off.data_ptr(), k, q,
                min(q, MAX_CHUNK), ns, _build.MONOID_CODES[monoid],
                _build.dtype_code(table.dtype, monoid), int(fn is not None),
                acc.data_ptr(), touched.data_ptr(), stream())
        return args, (acc, touched)

    def new_fused(table, monoid, fn, w, plain=False):
        tl, ev, wt = ((plain_tiles, plain_valid, plain_w) if plain
                      else (tiles, edge_valid, w))
        acc = torch.empty(ns, dtype=table.dtype, device=dev)
        touched = torch.empty(ns, dtype=torch.bool, device=dev)
        args = (table.data_ptr(), all_live.data_ptr(), ns,
                tl.edge_src_local.data_ptr(), tl.edge_dst_local.data_ptr(),
                ev.data_ptr(), wt.data_ptr() if fn else None,
                tl.tile_src_part.data_ptr(), tl.part_tile_off.data_ptr(), k,
                q, et, min(q, MAX_CHUNK), ns, _build.MONOID_CODES[monoid],
                _build.dtype_code(table.dtype, monoid), int(fn is not None),
                acc.data_ptr(), touched.data_ptr(), stream())
        return args, (acc, touched)

    nbytes = ns * 5 + ne * (4 + 4 + 1) + nt * 4 + (k + 1) * 8 + ns * 5
    for name, dname, monoid, fn in () if "fused" not in rows else (
            *((c[0], c[1], c[2], None) for c in cases),
            ("f32_min_add_weight", "f32", "min", add_weight)):
        table = payload(ns, dtypes[dname])
        w_chk = w_int if fn else None
        check_equal(fused_dc_cuda(table, all_live, edge_valid, ns, monoid,
                                  tiles, apply_weight=fn, w=w_chk),
                    run_c(old["fused"], old_fused(table, monoid, fn, w_chk)),
                    f"fused {name}")
        w = fk.edge_w
        fns = {"old": lambda a=old_fused(table, monoid, fn, w):
               run_c(old["fused"], a),
               "new": lambda t=table, m=monoid, f=fn: fused_dc_cuda(
                   t, all_live, edge_valid, ns, m, tiles, apply_weight=f,
                   w=w if f else None),
               "new_plain_loads": lambda a=new_fused(
                   table, monoid, fn, w, plain=True):
               run_c(_build.FUSED_DC, a)}
        extra_bytes = ne * 4 if fn else 0
        emit({"row": "fused", "case": name,
              "shape": {"table": ns, "edges": ne, "edge_tiles": nt, "k": k,
                        "q": q},
              "bytes": nbytes + extra_bytes,
              "bound_ms": bound_ms(nbytes + extra_bytes),
              "times": in_turns(fns, args.reps)})

    # ---------------- lanes ----------------
    lanes = 16
    le = build_lane_edges(tiles, edge_valid, fk.edge_w)
    live16 = torch.ones((lanes, ns), dtype=torch.bool, device=dev)

    def packed(n):
        """Packed min_with_payload words: random non-negative f32 keys, any
        uint32 payload."""
        keys = torch.rand(n, generator=gen, device=dev) * 1000
        pay = torch.randint(0, 2**32, (n,), generator=gen, device=dev)
        return (keys.view(torch.int32).to(torch.int64) << 32) | pay

    def lane_outputs(table):
        return (torch.empty((lanes, ns), dtype=table.dtype, device=dev),
                torch.empty((lanes, ns), dtype=torch.bool, device=dev))

    def codes_of(table, monoid, fn):
        return (_build.MONOID_CODES[monoid],
                _build.dtype_code(table.dtype, monoid), _EDGE_FNS[fn])

    def two_launches(k_il, k_fold, table, monoid, fn):
        """(interleave, fold, outputs): this tree's lane interface, each
        launch alone, on buffers allocated once."""
        acc, touched = lane_outputs(table)
        size, group = table.element_size(), lane_group(lanes)
        il = torch.empty((ns, lanes), dtype=table.dtype, device=dev)
        mk = torch.empty((ns, 1), dtype=torch.int32, device=dev)
        ia = (table.data_ptr(), live16.data_ptr(), ns, ns, lanes, size,
              le.rank.data_ptr(), il.data_ptr(), mk.data_ptr(), stream())
        fa = (il.data_ptr(), mk.data_ptr(), ns, lanes, le.src.data_ptr(),
              le.dst.data_ptr(), le.w.data_ptr() if fn else None,
              le.off.data_ptr(), k, q, le.fine,
              lane_width(group, size, q, le.fine), group, ns, ns,
              *codes_of(table, monoid, fn), acc.data_ptr(),
              touched.data_ptr(), stream())
        return (lambda: k_il.launch(*ia)), (lambda: k_fold.launch(*fa)), \
            (acc, touched)

    def old_lanes(table, monoid, fn):
        """The baseline's lane form: one call, and its outputs."""
        if iface["lanes"] == "this":
            il, fold, out = two_launches(old["interleave"], old["lanes"],
                                         table, monoid, fn)
            return (lambda: (il(), fold())), out
        acc, touched = lane_outputs(table)
        args = (table.data_ptr(), live16.data_ptr(), ns, ns,
                tiles.edge_src_local.data_ptr(),
                tiles.edge_dst_local.data_ptr(), edge_valid.data_ptr(),
                fk.edge_w.data_ptr() if fn else None,
                tiles.tile_src_part.data_ptr(),
                tiles.part_tile_off.data_ptr(), k, q, et,
                min(q, max_chunk(table.dtype)), ns, lanes, ns,
                *codes_of(table, monoid, fn), acc.data_ptr(),
                touched.data_ptr(), stream())
        return (lambda: old["lanes"].launch(*args)), (acc, touched)

    for name, monoid, fn in () if "lanes" not in rows else (
            ("f32_add", "add", None),
                             ("int64_min_add_weight_to_key",
                              "min_with_payload", add_weight_to_key)):
        table = (payload(lanes * ns).view(lanes, ns) if fn is None
                 else packed(lanes * ns).view(lanes, ns))
        w = fk.edge_w if fn else None
        old_call, old_out = old_lanes(table, monoid, fn)
        old_call()

        def new_call(t=table, m=monoid, f=fn, wt=w):
            return fused_dc_cuda(t, live16, edge_valid, ns, m, tiles,
                                 apply_weight=f, w=wt, lane_edges=le)
        check_equal(new_call(), old_out, f"lanes {name}")
        il_only, fold_only, _ = two_launches(
            _build.FUSED_DC_INTERLEAVE, _build.FUSED_DC_LANES, table, monoid,
            fn)
        il_only()
        lane_rows = [(table[i], live16[i]) for i in range(lanes)]
        fns = {"old": old_call, "new": new_call,
               "new_interleave_only": il_only, "new_fold_only": fold_only,
               "new_single_lane_x16": lambda r=lane_rows, m=monoid, f=fn,
               wt=w: [
                   fused_dc_cuda(t, v, edge_valid, ns, m, tiles,
                                 apply_weight=f, w=wt) for t, v in r]}
        # what the lane form must move: the edge copy's source rows and
        # local destinations (and weights) and its offsets, once for every
        # lane, and each lane's table, validity, acc and touched
        size = table.element_size()
        nbytes = (le.src.numel() * (4 + 4 + (4 if fn else 0))
                  + le.off.numel() * 8 + lanes * ns * (size + 1 + size + 1))
        emit({"row": "lanes", "case": name,
              "shape": {"lanes": lanes, "table": [lanes, ns], "edges": ne,
                        "copy_edges": le.src.numel(),
                        "copy_bytes": le.nbytes(),
                        "group": lane_group(lanes),
                        "width": lane_width(lane_group(lanes), size, q)},
              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "times": in_turns(fns, max(2, args.reps // 5))})
        del fns, old_call, old_out, il_only, fold_only, lane_rows, table
    del le, live16

    del fk, tiles, plain_tiles, plain_valid, plain_w

    # ---------------- gather ----------------
    sk = ScatterKernel(L, "add", torch.float32, dev)
    slots = (sk.png_src_local, sk.png_valid, sk.png_tile_part)
    nm, mt = L.num_msgs, L.msg_tile
    ident = identity_bits("add", torch.float32)
    x = payload(L.n_pad).view(k, q)
    regimes = _build.DC_GATHER.regimes

    def old_gather(active, pieces=None):
        """The baseline's launch arguments for one call, and its output."""
        out = torch.empty(nm, device=dev)
        ptrs = (x.data_ptr(), active.data_ptr(),
                *(a.data_ptr() for a in slots))
        if iface["gather"] == "slots":
            args = (*ptrs, nm, k, q, mt, ident, out.data_ptr(), stream())
        else:
            width = () if iface["gather"] == "four_byte" else (4,)
            args = (*ptrs, pieces.data_ptr() if pieces is not None else None,
                    pieces.numel() - 1 if pieces is not None else 0, nm, k,
                    q, mt, ident, *width, out.data_ptr(), x.device.index,
                    ctypes.byref(ctypes.c_int()), stream())
        return args, out

    def new_gather(active, pieces):
        return dc_gather_cuda(x, active, *slots, k=k, q=q, msg_tile=mt,
                              pieces=pieces)

    def regime_of(fn):
        before = dict(regimes)
        fn()
        return [r for r in regimes if regimes[r] != before[r]]

    nbytes = nm * (4 + 1 + 4) + (nm // mt) * 4 + L.n_pad * (4 + 1)
    for name, density in () if "gather" not in rows else (
            ("f32_add_all_live", 1.0),
                          ("f32_add_half_active", 0.5)):
        active = (torch.rand(L.n_pad, generator=gen, device=dev)
                  < density).view(k, q)
        want = run_c(old["gather"], old_gather(active))
        for pieces in (sk.pieces, None):
            check_equal(new_gather(active, pieces), want,
                        f"gather {name} pieces={pieces is not None}")
        fns = {"old": lambda a=old_gather(active, sk.pieces):
               run_c(old["gather"], a),
               "new": lambda a=active: new_gather(a, sk.pieces),
               "new_l2": lambda a=active: new_gather(a, None)}
        if iface["gather"] == "this":   # the baseline's L2 regime too
            fns["old_l2"] = lambda a=old_gather(active): run_c(
                old["gather"], a)
        emit({"row": "gather", "case": name,
              "shape": {"slots": nm, "slot_tiles": nm // mt, "k": k, "q": q,
                        "pieces": sk.pieces.numel() - 1},
              "regimes": {"new": regime_of(fns["new"]),
                          "new_l2": regime_of(fns["new_l2"])},
              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "times": in_turns(fns, args.reps)})

    del sk, x

    # ---------------- gather8 ----------------
    if iface["gather"] == "this" and "gather8" in rows:
        sk8 = ScatterKernel(L, "min_with_payload", torch.int64, dev)
        ident8 = identity_bits("min_with_payload", torch.int64)
        png_src = (sk8.png_tile_part.repeat_interleave(mt) * q
                   + sk8.png_src_local).to(torch.int64)
        slots8 = (sk8.png_src_local, sk8.png_valid, sk8.png_tile_part)
        for b in (1, 16):
            lead = () if b == 1 else (b,)
            x8 = packed(b * L.n_pad).view(lead + (k, q))
            act8 = torch.ones(lead + (k, q), dtype=torch.bool, device=dev)
            out8 = torch.empty(lead + (nm,), dtype=torch.int64, device=dev)
            lane_args = () if b == 1 else (b, k * q, nm)
            args8 = (x8.data_ptr(), act8.data_ptr(),
                     *(a.data_ptr() for a in slots8), sk8.pieces.data_ptr(),
                     sk8.pieces.numel() - 1, nm, k, q, mt, *lane_args,
                     ident8, 8, out8.data_ptr(), x8.device.index,
                     ctypes.byref(ctypes.c_int()), stream())
            kern8 = old["gather"] if b == 1 else old["gather_lanes"]

            def new8(p, x=x8, a=act8):
                return dc_gather_cuda(x, a, *slots8, k=k, q=q, msg_tile=mt,
                                      monoid="min_with_payload", pieces=p)
            kern8.launch(*args8)
            check_equal(new8(sk8.pieces), out8, f"gather8 lanes={b}")
            check_equal(new8(None), out8, f"gather8 lanes={b} l2")
            flat = x8.view(lead + (L.n_pad,))
            fns = {"old": lambda a=args8, kk=kern8: kk.launch(*a),
                   "new": lambda: new8(sk8.pieces),
                   "new_l2": lambda: new8(None),
                   "index_select": lambda f=flat: torch.index_select(
                       f, -1, png_src)}
            regs = _build.DC_GATHER.regimes if b == 1 else \
                _build.DC_GATHER_LANES.regimes
            before = dict(regs)
            new8(sk8.pieces)
            nbytes = (nm * (4 + 1) + (nm // mt) * 4
                      + b * (L.n_pad * (8 + 1) + nm * 8))
            emit({"row": "gather8", "case": f"min_with_payload lanes={b}",
                  "shape": {"slots": nm, "k": k, "q": q, "lanes": b,
                            "pieces": sk8.pieces.numel() - 1},
                  "regimes": {"new": [r for r in regs
                                      if regs[r] != before[r]]},
                  "bytes": nbytes, "bound_ms": bound_ms(nbytes),
                  "times": in_turns(fns, args.reps if b == 1
                                    else max(2, args.reps // 5))})
            del fns, x8, act8, out8, flat
        del sk8, png_src

    # ---------------- flat ----------------
    if "flat" in rows:
        from repro_torch.graph.shard import shard_layout
        from repro_torch.kernels.fused_step import (fused_stream_cuda,
                                                    part_ranges)
        t0 = time.perf_counter()
        SL = shard_layout(L, 1)
        report["shard_layout_s"] = time.perf_counter() - t0
        slot, fvalid, dstl, fw = (torch.from_numpy(a[0]).to(dev) for a in (
            SL.in_msg_slot, SL.in_valid, SL.in_dst_local, SL.in_w))
        parts = part_ranges(dstl, fvalid, SL.q, SL.kpd)
        fm, fns, fne = SL.D * SL.S + 1, SL.nv + 1, SL.ne_d
        del SL
        fw_int = payload(fne).abs()

        def old_flat(table, live, monoid, fn, w):
            acc = torch.empty(fns, dtype=table.dtype, device=dev)
            touched = torch.empty(fns, dtype=torch.bool, device=dev)
            ranges = ((parts.part_off.data_ptr(), parts.part_off.numel() - 1,
                       parts.q, parts.tile) if iface["flat"] == "this"
                      else ())
            args = (table.data_ptr(), live.data_ptr(), fm, slot.data_ptr(),
                    fvalid.data_ptr(), dstl.data_ptr(),
                    w.data_ptr() if fn else None, fne, *ranges, fns,
                    _build.MONOID_CODES[monoid],
                    _build.dtype_code(table.dtype, monoid), _EDGE_FNS[fn],
                    acc.data_ptr(), touched.data_ptr(), table.device.index,
                    stream())
            return args, (acc, touched)

        # PageRank's and SSSP-with-parents' steps with every slot live, and
        # BFS's (u32 min) with a share of the slots live
        for name, monoid, fn, share in (
                ("f32_add", "add", None, 1.0),
                ("int64_min_add_weight_to_key", "min_with_payload",
                 add_weight_to_key, 1.0),
                *((f"u32_min live {p}", "min", None, p)
                  for p in (0.5, 0.1, 0.01))):
            table = (packed(fm) if fn is not None else
                     payload(fm, torch.uint32 if monoid == "min"
                             else torch.float32))
            live = (torch.rand(fm, generator=gen, device=dev) < share
                    if share < 1 else torch.ones(fm, dtype=torch.bool,
                                                 device=dev))
            w_chk = fw_int if fn else None
            new_call = lambda t, w, p, lv=live, m=monoid, f=fn: \
                fused_stream_cuda(t, lv, slot, fvalid, dstl, fns, m,
                                  apply_weight=f, w=w if f else None, parts=p)
            want = run_c(old["flat"], old_flat(table, live, monoid, fn,
                                               w_chk))
            check_equal(new_call(table, w_chk, parts), want,
                        f"flat {name} parts")
            check_equal(new_call(table, w_chk, None), want,
                        f"flat {name} stream")
            del want
            fns_t = {"old": lambda a=old_flat(table, live, monoid, fn, fw):
                     run_c(old["flat"], a),
                     "new": lambda t=table, c=new_call: c(t, fw, parts),
                     "new_stream_regime": lambda t=table, c=new_call:
                     c(t, fw, None)}
            width = table.element_size()
            nbytes = fne * (4 + 4 + 1 + (4 if fn else 0)) \
                + fm * (width + 1) + fns * (width + 1)
            emit({"row": "flat", "case": name, "live_share": share,
                  "shape": {"table": fm, "edges": fne, "num_segments": fns,
                            "parts": parts.part_off.numel() - 1,
                            "tile": parts.tile},
                  "bytes": nbytes, "bound_ms": bound_ms(nbytes),
                  "times": in_turns(fns_t, args.reps)})
            del fns_t, table, live
        del slot, fvalid, dstl, fw, fw_int, parts

    # ---------------- fold ----------------
    rng = np.random.default_rng(args.seed)
    sc_ids = torch.from_numpy(g.indices[rng.integers(0, g.m, 332_010)]
                              .astype(np.int32)).to(dev)
    sc_valid = torch.rand(sc_ids.shape[0], generator=gen, device=dev) < 0.9
    ns2 = FOLD_CAP + FOLD_CAP // 2 + 1
    ev = torch.from_numpy(L.edge_valid.astype(bool)).to(dev)
    ids2 = torch.sort(torch.randint(0, ns2 - 1, (L.num_edges,),
                                    generator=gen, device=dev)).values
    ids2 = torch.where(ev, ids2, ns2 - 1).to(torch.int32)

    def old_fold(vals, valid, ids, fold_ns, monoid):
        acc = torch.empty(fold_ns, dtype=vals.dtype, device=dev)
        touched = torch.empty(fold_ns, dtype=torch.bool, device=dev)
        args = (vals.data_ptr(), valid.data_ptr(), ids.data_ptr(),
                ids.shape[0], fold_ns, _build.MONOID_CODES[monoid],
                _build.dtype_code(vals.dtype, monoid), acc.data_ptr(),
                touched.data_ptr(), vals.device.index, stream())
        return args, (acc, touched)

    for name, fold_ns, valid, ids, monoid, dtype in () \
            if "fold" not in rows else (
            ("n_pad_plus_1", L.n_pad + 1, sc_valid, sc_ids, "min",
             torch.float32),
            ("ids_mod_4096", 4096, sc_valid, sc_ids % 4096, "min",
             torch.float32),
            ("fold2", ns2, ev, ids2, "min", torch.float32),
            ("n_pad_plus_1", L.n_pad + 1, sc_valid, sc_ids,
             "min_with_payload", torch.int64)):
        m = ids.shape[0]
        vals = (payload(m) if dtype == torch.float32 else
                torch.randint(0, 2**62, (m,), generator=gen, device=dev))
        check_equal(segment_fold_cuda(vals, valid, ids, fold_ns, monoid),
                    run_c(old["fold"], old_fold(vals, valid, ids, fold_ns,
                                                monoid)),
                    f"fold {name} {monoid}")
        fns = {"old": lambda a=old_fold(vals, valid, ids, fold_ns, monoid):
               run_c(old["fold"], a),
               "new": lambda v=vals, ok=valid, i=ids, n=fold_ns, mo=monoid:
               segment_fold_cuda(v, ok, i, n, mo)}
        width = vals.element_size()
        nbytes = m * (width + 1 + 4) + fold_ns * (width + 1)
        emit({"row": "fold", "case": f"{name} {monoid} {dtype}",
              "shape": {"messages": m, "num_segments": fold_ns},
              "bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "times": in_turns(fns, args.reps)})

    Path(args.report).parent.mkdir(parents=True, exist_ok=True)
    Path(args.report).write_text(json.dumps(report, indent=1))
    return 0


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

"""The port's distributed engine (``repro_torch.dist``) on the CPU, against
the reference.

  * The wire codecs and ``dc_wire_bytes`` bit for bit with
    :mod:`repro.dist.engine`'s, odd ``S`` included.
  * The layout-free fused step (``FusedStreamKernel``, the dist gather) on
    unsorted ``dst`` against the reference's Pallas kernel in interpret
    mode and its pure-jnp oracle, every monoid and edge function.
  * ``DistEngine`` on 1, 2 and 4 gloo ranks (``tests/torch_dist_ranks.py``:
    one process a rank, each with its own wall limit) running the port's
    apps: BFS, SSSP, SSSP with parents and CC in modes dc, sc, hybrid and
    hybrid_pp bit-exact with the reference single-device ``Engine``
    (PageRank within L1 1e-6), the batched apps lane for lane, and one SC
    step's dense and ragged forms equal.  PageRank's DC step built with
    ``dense_frontier`` equals the flagged step and the reference's
    dense-frontier engine.
  * The per-iteration stats equal the reference ``DistEngine``'s (run in a
    subprocess on D virtual host devices, under the ``check_vma`` shim of
    ``tests/torch_reference_shims.py``), field for field but ``wall_s``.
"""
import json
import os
import subprocess
import sys
import textwrap
from datetime import timedelta
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.apps as ref_apps
import repro.dist.engine as ref_dist
from repro.core import monoid as RM
from repro.graph import build_layout, rmat, symmetrize
from repro.kernels import fused_step as ref_fused_step
from repro_torch.apps import bfs_program
from repro_torch.core import monoid as TM
from repro_torch.dist import engine as port_dist
from repro_torch.dist import make_mesh
from repro_torch.graph import build_layout as port_build_layout
from repro_torch.graph import rmat as port_rmat
from repro_torch.graph.shard import shard_layout
from repro_torch.interop import packed_to_numpy
from repro_torch.kernels.fused_step import add_weight, add_weight_to_key
from repro_torch.kernels.ops import FusedStreamKernel
from torch_dist_ranks import Ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODES = ("dc", "sc", "hybrid", "hybrid_pp")
RANKS = (1, 2, 4)
ARGS = dict(scale=9, seed=1, k=8)
TILES = dict(k=ARGS["k"], edge_tile=64, msg_tile=32)
PR_ITERS, DAMPING = 10, 0.85


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8).reshape(-1)


def _same(port, ref, what=""):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, (
        what, port.dtype, ref.dtype, port.shape, ref.shape)
    assert np.array_equal(_bits(port), _bits(ref)), what


# ----------------------------------------------------------------------
# wire codecs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
@pytest.mark.parametrize("S", [1, 7, 8, 13, 16])
def test_wire_codecs_match_reference(S, lead):
    rng = np.random.default_rng(S)
    vals = rng.standard_normal(lead + (S,)).astype(np.float32) * 100
    vals[..., 0] = np.inf
    flags = rng.random(lead + (S,)) < 0.5
    jb = jnp.asarray(vals).astype(jnp.bfloat16)
    tb = torch.from_numpy(vals).to(torch.bfloat16)
    ref_packed = np.asarray(ref_dist._pack_bf16_pairs(jb, jnp.inf))
    packed = port_dist._pack_bf16_pairs(tb, float("inf"))
    _same(packed.numpy().view(np.uint32), ref_packed, "bf16 pairs")
    _same(port_dist._unpack_bf16_pairs(packed, S).float().numpy(),
          np.asarray(ref_dist._unpack_bf16_pairs(jnp.asarray(ref_packed), S)
                     ).astype(np.float32), "bf16 unpack")
    ref_bits = np.asarray(ref_dist._pack_bits(jnp.asarray(flags)))
    bits = port_dist._pack_bits(torch.from_numpy(flags))
    _same(bits.numpy(), ref_bits, "bitmap")
    _same(port_dist._unpack_bits(bits, S).numpy(), flags, "bitmap unpack")


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("bitmap", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("S", [7, 16])
def test_dc_wire_bytes_matches_reference(S, compressed, bitmap, dense, batch):
    meta = dict(S=S, D=4)
    kw = dict(compressed=compressed, wire_bitmap=bitmap,
              dense_frontier=dense, batch=batch)
    for itemsize in (4, 8):
        assert port_dist.dc_wire_bytes(meta, itemsize, **kw) == \
            ref_dist.dc_wire_bytes(meta, itemsize, **kw)


# ----------------------------------------------------------------------
# the layout-free fused step (the dist gather's kernel)
# ----------------------------------------------------------------------

def _stream_case(seed, m=70, ne=300, ns=41):
    """Edges with unsorted dst (some outside [0, ns)), idx past the table
    (clamped), mixed validity."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, m + 3, ne).astype(np.int32)
    dst = rng.integers(-2, ns + 2, ne).astype(np.int32)
    assert np.any(np.diff(dst) < 0)
    return (rng.random(m) < 0.7, idx, rng.random(ne) < 0.8, dst,
            rng.integers(0, 9, ne).astype(np.float32), ns)


def _table(rng, m, dtype):
    lo = 0 if dtype == "uint32" else -64
    return rng.integers(lo, 64, m).astype(dtype)


STREAM_CASES = [(m, d, None) for m in ("add", "min", "max")
                for d in ("float32", "int32", "uint32")]
STREAM_CASES += [("min", "float32", "add_weight"),
                 ("add", "float32", "add_weight")]


@pytest.mark.parametrize("monoid,dtype,edge", STREAM_CASES)
def test_fused_stream_matches_reference(monoid, dtype, edge):
    tvalid, idx, evalid, dst, w, ns = _stream_case(len(monoid) + len(dtype))
    table = _table(np.random.default_rng(3), tvalid.shape[0], dtype)
    port = FusedStreamKernel(monoid, getattr(torch, dtype))(
        torch.from_numpy(table.view(np.int32) if dtype == "uint32"
                         else table).view(getattr(torch, dtype)),
        torch.from_numpy(tvalid), torch.from_numpy(idx),
        torch.from_numpy(evalid), torch.from_numpy(dst), ns,
        w=torch.from_numpy(w) if edge else None,
        apply_weight=add_weight if edge else None)
    args = [jnp.asarray(a) for a in (table, tvalid, idx, evalid, dst)]
    relax = (lambda v, wt: v + wt) if edge else None
    ref = ref_fused_step.fused_scatter_fold(
        *args, ns, monoid=monoid, edge_tile=32, fold_q=16, interpret=True,
        apply_weight=relax, w=jnp.asarray(w) if edge else None)
    oracle = ref_fused_step.ref_fused_scatter_fold(
        RM.REGISTRY[monoid](jnp.dtype(dtype)), *args, ns,
        apply_weight=relax, w=jnp.asarray(w) if edge else None)
    for want in (ref, oracle):
        _same(TM.as_bits(port[0]).numpy().view(dtype), want[0], "acc")
        _same(port[1].numpy(), want[1], "touched")


@pytest.mark.parametrize("edge", [None, "add_weight_to_key"])
def test_fused_stream_int64_matches_reference(edge):
    """The 8-byte min of ``min_with_payload`` (SSSP with parents) against
    the reference's oracle on its ``uint64`` words."""
    import jax
    tvalid, idx, evalid, dst, w, ns = _stream_case(11)
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50, tvalid.shape[0]).astype(np.float32)
    payload = rng.integers(0, 2**32, tvalid.shape[0], dtype=np.uint64)
    words = (keys.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | payload
    port = FusedStreamKernel("min_with_payload", torch.int64)(
        torch.from_numpy(words.view(np.int64)), torch.from_numpy(tvalid),
        torch.from_numpy(idx), torch.from_numpy(evalid),
        torch.from_numpy(dst), ns, w=torch.from_numpy(w) if edge else None,
        apply_weight=add_weight_to_key if edge else None)
    with jax.enable_x64(True):
        mono = RM.min_with_payload()

        def relax(v, wt):
            key, pay = RM.unpack_key_payload(v)
            return RM.pack_key_payload(key + wt, pay)
        ref = ref_fused_step.ref_fused_scatter_fold(
            mono, jnp.asarray(words), jnp.asarray(tvalid), jnp.asarray(idx),
            jnp.asarray(evalid), jnp.asarray(dst), ns,
            apply_weight=relax if edge else None,
            w=jnp.asarray(w) if edge else None)
        ref = [np.asarray(r) for r in ref]
    # the identities differ (INT64_MAX, the reference's UINT64_MAX): the
    # folded words are compared where a segment was touched
    touched = port[1].numpy()
    _same(touched, ref[1], "touched")
    _same(packed_to_numpy(port[0])[touched], ref[0][touched], "acc")
    assert np.all(port[0].numpy()[~touched] == np.iinfo(np.int64).max)


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------

def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh("cpu")


def test_mesh_rules_on_one_gloo_rank(tmp_path):
    """One in-process rank: the CPU mesh, the refused pairings and a
    layout sharded for another rank count."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert mesh.axis_names == ("dev",)
        with pytest.raises(ValueError, match="nccl"):
            make_mesh("cuda")
        L = port_build_layout(port_rmat(6, 4, seed=0), k=4, edge_tile=16,
                              msg_tile=8)
        with pytest.raises(ValueError, match="D=2"):
            port_dist.DistEngine(shard_layout(L, 2), bfs_program(), mesh)
        with pytest.raises(ValueError, match="mode"):
            port_dist.DistEngine(shard_layout(L, 1), bfs_program(), mesh,
                                 mode="pp")
        eng = port_dist.DistEngine(shard_layout(L, 1), bfs_program(), mesh)
        assert eng.device == torch.device("cpu") and eng.fused
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the engine on gloo ranks
# ----------------------------------------------------------------------

def _graph():
    g = rmat(ARGS["scale"], 8, seed=ARGS["seed"], weighted=True)
    src = int(np.argmax(g.out_degrees()))
    sources = [src] + [int(s) for s in
                       np.random.default_rng(0).choice(g.n, 3,
                                                       replace=False)]
    return g, src, sources


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ``apps`` scenario on 1, 2 and 4 gloo ranks and the
    reference DistEngine at D = 2 and 4, all started at once: each rank's
    results (by rank count) and the reference's stats (by D)."""
    _, src, sources = _graph()
    port = {D: Ranks("apps", D, tmp_path_factory.mktemp(f"ranks{D}"),
                     dict(ARGS, D=D, source=src, sources=sources,
                          modes=MODES))
            for D in RANKS}
    ref = {D: _start_reference_dist(D, src) for D in (2, 4)}
    return {"port": {D: r.results() for D, r in port.items()},
            "ref_stats": {D: _reference_stats(p) for D, p in ref.items()}}


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs["port"]


@pytest.fixture(scope="module")
def reference_dist_stats(runs):
    return runs["ref_stats"]


@pytest.fixture(scope="module")
def reference():
    """The reference single-device apps (``ref`` backend) on the same
    graphs, the 8-byte ones left to the tests (they need the x64 shim)."""
    g, src, sources = _graph()
    L = build_layout(g, **TILES)
    LS = build_layout(symmetrize(g), **TILES)
    out = {"L": L, "src": src, "sources": sources}
    for mode in ("hybrid", "dc", "sc"):
        out[("bfs", mode)] = ref_apps.bfs(L, src, mode=mode, backend="ref")
        out[("sssp", mode)] = ref_apps.sssp(L, src, mode=mode, backend="ref")
        out[("cc", mode)] = ref_apps.connected_components(LS, mode=mode,
                                                          backend="ref")
    out["pagerank"] = ref_apps.pagerank(L, iters=PR_ITERS, damping=DAMPING,
                                        backend="ref")
    out["bfs_multi"] = ref_apps.bfs_multi(L, sources, backend="ref")
    out["sssp_multi"] = ref_apps.sssp_multi(L, sources, backend="ref")
    return out


FIELDS = {"bfs": ("parent", "level"), "sssp": ("dist",),
          "sssp_parents": ("dist", "parent"), "cc": ("label",)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app", ["bfs", "sssp", "cc"])
@pytest.mark.parametrize("D", RANKS)
def test_dist_apps_match_single_device_reference(port_runs, reference, D,
                                                 app, mode):
    want = reference[(app, "hybrid" if mode == "hybrid_pp" else mode)]
    for rank, res in enumerate(port_runs[D]):
        got = res[(app, mode)]
        for field in FIELDS[app]:
            _same(got[field], want[field], f"rank {rank} {field}")


@pytest.fixture(scope="module")
def reference_parents(reference):
    """The reference's 8-byte apps (x64 shim for this fixture only):
    ``sssp_with_parents`` (hybrid; its answer does not depend on the mode)
    and ``sssp_parents_multi``."""
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        return {"single": ref_apps.sssp_with_parents(
                    reference["L"], reference["src"], backend="ref"),
                "multi": ref_apps.sssp_parents_multi(
                    reference["L"], reference["sources"])}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D", RANKS)
def test_dist_sssp_with_parents_matches_reference(port_runs,
                                                  reference_parents, D, mode):
    want = reference_parents["single"]
    for res in port_runs[D]:
        got = res[("sssp_parents", mode)]
        _same(got["dist"], want["dist"], "dist")
        _same(got["parent"], want["parent"], "parent")


@pytest.mark.parametrize("path", ["run", "run_fused"])
@pytest.mark.parametrize("D", RANKS)
def test_dist_pagerank_matches_reference(port_runs, reference, D, path):
    want = np.asarray(reference["pagerank"]["pr"], np.float64)
    for res in port_runs[D]:
        got = res[("pagerank", path)]["pr"]
        assert got.dtype == np.float32
        assert np.abs(got.astype(np.float64) - want).sum() <= 1e-6


@pytest.mark.parametrize("D", RANKS)
def test_dist_pagerank_bf16_wire_within_its_rounding(port_runs, D):
    """On the bf16 wire every message carries a relative rounding error of
    at most 2**-9 (round to nearest, 8 significant bits).  An iteration
    sends ``d * ||msgs||_1 <= d * ||pr||_1`` of mass, and the column-
    stochastic step does not grow an L1 error, so after ``t`` iterations
    ``||pr_bf16 - pr_f32||_1 <= 2**-9 * ||pr||_1 * sum_{j=1..t} d**j``;
    1e-6 of f32 summation order on top."""
    d, t = DAMPING, PR_ITERS
    for res in port_runs[D]:
        f32 = res[("pagerank", "run")]["pr"].astype(np.float64)
        bf16 = res[("pagerank", "bf16")]["pr"].astype(np.float64)
        bound = 2.0 ** -9 * f32.sum() * d * (1 - d ** t) / (1 - d) + 1e-6
        err = np.abs(bf16 - f32).sum()
        assert 0 < err <= bound, (err, bound)


@pytest.mark.parametrize("D", RANKS)
def test_dist_pagerank_dense_frontier(port_runs, reference_dist_stats, D):
    """The DC step built with ``dense_frontier`` (no flag exchange: the
    receive side's static ``in_valid`` stands for the flags) gives the same
    bits as the flagged step when every vertex is active, and the
    reference's dense-frontier DistEngine's PageRank within L1 1e-6."""
    for res in port_runs[D]:
        got = res[("pagerank", "dense")]["pr"]
        _same(got, res[("pagerank", "run")]["pr"], "pr")
        for ref_d in (2, 4):
            want = np.asarray(reference_dist_stats[ref_d]["pagerank/dense_pr"])
            assert np.abs(got.astype(np.float64) - want).sum() <= 1e-6


@pytest.mark.parametrize("app", ["bfs_multi", "sssp_multi"])
@pytest.mark.parametrize("D", RANKS)
def test_dist_run_batched_matches_reference(port_runs, reference, D, app):
    want = reference[app]
    for res in port_runs[D]:
        got = res[(app, "dc")]
        for field in FIELDS[app.split("_multi")[0]]:
            _same(got[field], want[field], field)
        assert [(s.it, s.lanes_active, s.n_active) for s in got["stats"]] \
            == [(s.it, s.lanes_active, s.n_active) for s in want["stats"]]


@pytest.mark.parametrize("D", RANKS)
def test_dist_sssp_parents_multi_matches_reference(port_runs,
                                                   reference_parents, D):
    want = reference_parents["multi"]
    for res in port_runs[D]:
        got = res[("sssp_parents_multi", "dc")]
        _same(got["dist"], want["dist"], "dist")
        _same(got["parent"], want["parent"], "parent")


@pytest.mark.parametrize("D", RANKS)
def test_dense_and_ragged_sc_agree(port_runs, D):
    for res in port_runs[D]:
        (dense_d, dense_a), (ragged_d, ragged_a) = (res["sc_step"][False],
                                                    res["sc_step"][True])
        _same(ragged_d, dense_d, "dist")
        _same(ragged_a, dense_a, "active")
        assert dense_a.any()


# ----------------------------------------------------------------------
# stats against the reference DistEngine
# ----------------------------------------------------------------------

REF_DIST = textwrap.dedent("""
    import functools, json, sys
    import numpy as np
    from torch_reference_shims import dist_check_vma_shim
    dist_check_vma_shim()
    import repro.apps as A
    import repro.dist.engine as RE
    from repro.dist.compat import AxisType, make_mesh
    from repro.dist.engine import DistEngine
    from repro.graph import build_layout, rmat, symmetrize
    from repro.graph.shard import shard_layout

    a = json.loads(sys.argv[1])
    D = a["D"]
    mesh = make_mesh((D,), ("dev",), axis_types=(AxisType.Auto,))
    g = rmat(a["scale"], 8, seed=a["seed"], weighted=True)
    tiles = dict(k=a["k"], edge_tile=64, msg_tile=32)
    L, LS = build_layout(g, **tiles), build_layout(symmetrize(g), **tiles)
    SL, SLS = shard_layout(L, D), shard_layout(LS, D)

    def stats(res):
        return [{k: v for k, v in s.items() if k != "wall_s"}
                for s in res["stats"]]

    out = {}
    for mode in a["modes"]:
        eng = lambda sl, prog, **kw: DistEngine(sl, prog, mesh, mode=mode,
                                                **kw)
        out["bfs/" + mode] = stats(A.bfs(
            L, a["source"], engine=eng(SL, A.bfs_program())))
        out["sssp/" + mode] = stats(A.sssp(
            L, a["source"], engine=eng(SL, A.sssp_program())))
        out["cc/" + mode] = stats(A.connected_components(
            LS, engine=eng(SLS, A.cc_program())))
    for name, bf16 in (("run", False), ("bf16", True)):
        out["pagerank/" + name] = stats(A.pagerank(
            L, iters=a["iters"], fused=False, engine=DistEngine(
                SL, A.pagerank_program(g.n), mesh, mode="dc",
                wire_bf16=bf16)))
    build = RE.build_dc_step
    RE.build_dc_step = functools.partial(build, dense_frontier=True)
    dense = DistEngine(SL, A.pagerank_program(g.n), mesh, mode="dc")
    RE.build_dc_step = build
    res = A.pagerank(L, iters=a["iters"], fused=False, engine=dense)
    out["pagerank/dense"] = stats(res)
    out["pagerank/dense_pr"] = np.asarray(res["pr"], np.float64).tolist()
    print("STATS" + json.dumps(out))
""")


def _start_reference_dist(D, src):
    """The reference DistEngine's runs on D virtual host devices, in a
    subprocess (the device count is fixed before JAX starts)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={D}",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    args = dict(ARGS, D=D, source=src, modes=MODES, iters=PR_ITERS)
    return subprocess.Popen([sys.executable, "-c", REF_DIST,
                             json.dumps(args)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _reference_stats(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the reference DistEngine outlived {timeout} s")
    assert proc.returncode == 0, out + err
    line = next(s for s in out.splitlines() if s.startswith("STATS"))
    return json.loads(line[len("STATS"):])


REF_RUNS = [f"{app}/{mode}" for app in ("bfs", "sssp", "cc")
            for mode in MODES] + ["pagerank/run", "pagerank/bf16",
                                  "pagerank/dense"]


@pytest.mark.parametrize("run", REF_RUNS)
@pytest.mark.parametrize("D", [2, 4])
def test_dist_stats_match_reference_dist_engine(port_runs, reference_dist_stats,
                                                D, run):
    app, mode = run.split("/")
    key = (app, mode)
    want = reference_dist_stats[D][run]
    assert want, "the reference ran no iteration"
    for res in port_runs[D]:
        got = [{k: v for k, v in s.items() if k != "wall_s"}
               for s in res[key]["stats"]]
        assert got == want

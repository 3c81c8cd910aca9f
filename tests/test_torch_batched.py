"""The port's batched engine on the CPU against ``repro``'s.

``bfs_multi`` and ``sssp_multi`` (``Engine.run_batched``) against the
reference's under both of its backends, ``ref`` and ``pallas-interpret``, on
both DC lowerings (fused, and composed under ``REPRO_FUSED=0``): parents,
levels and distances bit-exact (min folds are exact in any order), the
``BatchIterStats`` records equal but for ``wall_s``.  The lane forms' plain
versions against the reference's vmap rules (``jax.vmap`` over
``RefFusedDC``, ``RefGather`` and ``RefScatter``) on integer payloads, exact
under any order.  Then the pieces: lane compaction, the converged-lane
freeze, the ``or`` monoid, and ``[B, n_pad]`` state through ``interop``.
The layout is the reference serving tests' (``tests/test_serve.py``): RMAT
scale 8, weighted, ``k=8``, ``edge_tile=64``, ``msg_tile=32``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # kernel_harness imports it
from kernel_harness import payload

import repro.apps as ref_apps
import repro_torch as rt
from repro.core import engine as ref_engine
from repro.core import monoid as RM
from repro.graph import build_layout, rmat
from repro.kernels import ops as ref_ops
from repro_torch.core import engine as port_engine
from repro_torch.core import monoid as M
from repro_torch.interop import layout_from_reference, state_to_torch, to_torch
from repro_torch.kernels import ops
from repro_torch.kernels.fold_block import segment_fold
from repro_torch.kernels.fused_step import add_weight

torch.set_num_threads(1)

BACKENDS = ("ref", "pallas-interpret")
LOWERINGS = ("fused", "composed")
MONOIDS = ("add", "min", "max")
DTYPES = ("float32", "int32", "uint32")


@pytest.fixture(scope="module")
def layouts():
    L = build_layout(rmat(8, 8, seed=3, weighted=True), k=8, edge_tile=64,
                     msg_tile=32)
    return L, layout_from_reference(L)


@pytest.fixture
def lowering(request, monkeypatch):
    """``REPRO_FUSED`` for both packages' engines built in the test."""
    monkeypatch.setenv("REPRO_FUSED", "1" if request.param == "fused" else "0")
    return request.param


def _sources(layout, b):
    """b distinct sources spread over the vertex ids (the reference's
    serving tests' spread)."""
    return [int(s) for s in np.linspace(0, layout.n - 1, b).astype(np.int64)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _same_batch_stats(port, ref):
    key = lambda s: (s.it, s.lanes_active, s.n_active)
    assert [key(s) for s in port] == [key(s) for s in ref]
    assert all(s.wall_s >= 0 for s in port)


def _engine_path(eng, lowering):
    assert eng.fused == (lowering == "fused")


@pytest.mark.parametrize("lanes", [16, 1])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_bfs_multi_matches_reference(layouts, lowering, backend, lanes):
    L, TL = layouts
    sources = _sources(L, lanes)
    ref = ref_apps.bfs_multi(L, sources, backend=backend)
    eng = rt.Engine(TL, rt.apps.bfs_program(), mode="dc", device="cpu")
    _engine_path(eng, lowering)
    port = rt.bfs_multi(TL, sources, engine=eng)
    assert port["level"].shape == (lanes, L.n)
    _same(port["parent"], ref["parent"])
    _same(port["level"], ref["level"])
    _same_batch_stats(port["stats"], ref["stats"])


@pytest.mark.parametrize("lanes", [16, 1])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_sssp_multi_matches_reference(layouts, lowering, backend, lanes):
    L, TL = layouts
    sources = _sources(L, lanes)
    ref = ref_apps.sssp_multi(L, sources, backend=backend)
    eng = rt.Engine(TL, rt.apps.sssp_program(), mode="dc", device="cpu")
    _engine_path(eng, lowering)
    port = rt.sssp_multi(TL, sources, engine=eng)
    assert port["dist"].shape == (lanes, L.n)
    _same(port["dist"], ref["dist"])
    _same_batch_stats(port["stats"], ref["stats"])


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_batched_runs_equal_sequential_runs(layouts, lowering):
    """Each lane bit-exact with the port's own sequential run from its
    source, as the reference's serving tests hold its batch."""
    _, TL = layouts
    sources = _sources(TL, 16)
    bfs = rt.bfs_multi(TL, sources, device="cpu")
    sssp = rt.sssp_multi(TL, sources, device="cpu")
    for i, s in enumerate(sources):
        seq = rt.bfs(TL, source=s, device="cpu")
        _same(bfs["level"][i], seq["level"])
        _same(bfs["parent"][i], seq["parent"])
        _same(sssp["dist"][i], rt.sssp(TL, source=s, device="cpu")["dist"])


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_sssp_multi_warm_start_matches_reference(layouts, lowering):
    """``dist0`` / ``frontier0``: lanes seeded with upper bounds (each
    source's distances plus 1) mixed with a cold lane."""
    L, TL = layouts
    sources = _sources(L, 4)
    B, n_pad = len(sources), L.n_pad
    cold = ref_apps.sssp_multi(L, sources, backend="ref")["dist"]
    dist0 = np.full((B, n_pad), np.inf, np.float32)
    dist0[:, :L.n] = cold + 1.0
    dist0[np.arange(B), sources] = 0.0
    dist0[B - 1] = np.inf                       # the last lane starts cold
    dist0[B - 1, sources[-1]] = 0.0
    frontier0 = np.isfinite(dist0)
    ref = ref_apps.sssp_multi(L, sources, backend="ref", dist0=dist0,
                              frontier0=frontier0)
    port = rt.sssp_multi(TL, sources, dist0=dist0, frontier0=frontier0,
                         device="cpu")
    _same(port["dist"], ref["dist"])
    _same_batch_stats(port["stats"], ref["stats"])
    _same(port["dist"], rt.sssp_multi(TL, sources, device="cpu")["dist"])


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_run_batched_freezes_converged_lanes(layouts, lowering):
    """A lane whose frontier drains early keeps its final state while the
    other continues (the freeze inside a step, compaction between steps),
    as ``tests/test_serve.py``'s test of the reference."""
    L, TL = layouts
    deg = L.deg
    lo, hi = int(np.argmin(deg[:L.n])), int(np.argmax(deg[:L.n]))
    res = rt.bfs_multi(TL, [lo, hi], device="cpu")
    ref = ref_apps.bfs_multi(L, [lo, hi], backend="ref")
    for i, s in enumerate((lo, hi)):
        _same(res["level"][i], rt.bfs(TL, source=s, device="cpu")["level"])
        _same(res["level"][i], ref["level"][i])
    lanes = [s.lanes_active for s in res["stats"]]
    assert lanes[0] == 2 and min(lanes) == 1


def test_batched_step_freezes_an_empty_lane(layouts):
    """Inside one step: a lane with no active vertex comes back unchanged,
    its frontier empty, whatever its program would do to it."""
    _, TL = layouts
    n_pad = TL.n_pad
    eng = rt.Engine(TL, rt.apps.nibble_program(1e-4), mode="dc", device="cpu")
    deg = torch.from_numpy(TL.deg.astype(np.float32))
    pr = torch.rand((2, n_pad), generator=torch.Generator().manual_seed(0))
    active = torch.zeros((2, n_pad), dtype=torch.bool)
    active[0, :TL.n] = True
    states, new_active = eng.batched_step(
        {"pr": pr, "deg": deg.expand(2, n_pad)}, active, 0)
    assert torch.equal(states["pr"][1], pr[1])
    assert not new_active[1].any()
    assert not torch.equal(states["pr"][0], pr[0])


@pytest.mark.parametrize("seed", range(6))
def test_compact_lane_index_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lane_act = rng.random(int(rng.integers(1, 40))) < rng.random()
    lane_act[rng.integers(len(lane_act))] = True
    want, want_w = ref_engine._compact_lane_index(lane_act)
    got, got_w = port_engine._compact_lane_index(lane_act)
    assert got_w == want_w
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_run_batched_until_empty_false_skips_empty_steps(layouts):
    """``until_empty=False`` loops on over drained lanes as no-op steps,
    with no record, as the reference's loop does."""
    L, TL = layouts
    sources = np.array(_sources(L, 3))
    B, n_pad = len(sources), L.n_pad
    parent = np.full((B, n_pad), -1, np.int32)
    parent[np.arange(B), sources] = sources
    level = np.where(parent >= 0, 0, -1).astype(np.int32)
    vid = np.broadcast_to(np.arange(n_pad, dtype=np.uint32), (B, n_pad))
    frontier = parent >= 0
    ref_eng = ref_engine.Engine(L, ref_apps.bfs_program(), mode="dc",
                                backend="ref")
    ref_states, _, ref_stats = ref_eng.run_batched(
        {"parent": jnp.asarray(parent), "level": jnp.asarray(level),
         "vid": jnp.asarray(vid)}, frontier, max_iters=40, until_empty=False)
    eng = rt.Engine(TL, rt.apps.bfs_program(), mode="dc", device="cpu")
    states, active, stats = eng.run_batched(
        {"parent": torch.from_numpy(parent), "level": torch.from_numpy(level),
         "vid": torch.from_numpy(vid.copy())}, frontier, max_iters=40,
        until_empty=False)
    _same_batch_stats(stats, ref_stats)
    assert len(stats) < 40 and not active.any()
    for key in ("parent", "level", "vid"):
        _same(states[key].numpy(), ref_states[key])


def test_run_batched_takes_2d_frontiers_only(layouts):
    _, TL = layouts
    eng = rt.Engine(TL, rt.apps.sssp_program(), mode="dc", device="cpu")
    with pytest.raises(ValueError, match=r"\[B, n_pad\]"):
        eng.run_batched({"dist": torch.zeros(TL.n_pad)},
                        np.zeros(TL.n_pad, bool))


# ---- the lane forms' plain versions against the reference's vmap rules ----

def _lanes(rng, B, n, dtype):
    return jnp.stack([payload(rng, n, dtype) for _ in range(B)])


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monoid", MONOIDS)
def test_fused_lanes_match_reference_vmap(layouts, monoid, dtype, B):
    """``FusedDCKernel`` on ``[B, n_pad + 1]`` against ``jax.vmap`` of
    ``RefFusedDC`` (its ``custom_vmap`` rule); lane 0 all invalid."""
    L, TL = layouts
    rng = np.random.default_rng(B)
    table = _lanes(rng, B, L.n_pad + 1, dtype)
    valid = rng.random((B, L.n_pad + 1)) < 0.5
    valid[0] = False
    oracle = ref_ops.RefFusedDC(L, RM.REGISTRY[monoid](jnp.dtype(dtype)))
    want = jax.vmap(oracle)(table, jnp.asarray(valid))
    got = ops.FusedDCKernel(TL, monoid, getattr(torch, dtype), "cpu")(
        to_torch(table, "cpu"), to_torch(valid, "cpu"))
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert not got[1][0].any()


def test_fused_lanes_add_weight_match_reference_vmap(layouts):
    """SSSP's edge function (f32 min), per lane."""
    L, TL = layouts
    rng = np.random.default_rng(11)
    table = _lanes(rng, 4, L.n_pad + 1, "float32")
    valid = jnp.asarray(rng.random((4, L.n_pad + 1)) < 0.5)
    oracle = ref_ops.RefFusedDC(L, RM.min_(jnp.float32))
    oracle.apply_weight = lambda v, w: v + w
    want = jax.vmap(oracle)(table, valid)
    kern = ops.FusedDCKernel(TL, "min", torch.float32, "cpu",
                             apply_weight=add_weight)
    got = kern(to_torch(table, "cpu"), to_torch(valid, "cpu"))
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monoid", MONOIDS)
def test_gather_and_scatter_lanes_match_reference_vmap(layouts, monoid, dtype,
                                                       B):
    """``ScatterKernel`` and ``GatherKernel`` on ``[B, ...]`` against
    ``jax.vmap`` of ``RefScatter`` and of ``RefGather`` (its
    ``custom_vmap`` rule), each lane with its own source partitions."""
    L, TL = layouts
    mono = RM.REGISTRY[monoid](jnp.dtype(dtype))
    rng = np.random.default_rng(20 + B)
    x = _lanes(rng, B, L.n_pad, dtype)
    active = jnp.asarray(rng.random((B, L.n_pad)) < 0.5)
    sk = ops.ScatterKernel(TL, monoid, getattr(torch, dtype), "cpu")
    _same(sk(to_torch(x, "cpu"), to_torch(active, "cpu")),
          jax.vmap(ref_ops.RefScatter(L, mono))(x, active))

    vals = _lanes(rng, B, L.num_edges, dtype)
    valid = jnp.asarray(L.edge_valid & (rng.random((B, L.num_edges)) < 0.7))
    part_active = rng.random((B, L.k)) < 0.6
    part_active[0] = False
    gk = ops.GatherKernel(TL, monoid, getattr(torch, dtype), "cpu")
    acc, touched = gk(to_torch(vals, "cpu"), to_torch(valid, "cpu"),
                      to_torch(part_active, "cpu"))
    want = jax.vmap(ref_ops.RefGather(L, mono))(
        vals, valid, jnp.asarray(part_active.astype(np.int32)))
    _same(acc, want[0])
    _same(touched, want[1])
    assert not touched[0].any()


# ---- the or monoid and interop ----

def test_or_monoid_matches_reference():
    """``or``: uint32, identity 0, ``combine`` a bitwise or, and the fold a
    segmented max, as the reference defines it."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    ref, port = RM.or_(), M.or_()
    assert port.dtype == torch.uint32 and port.identity == 0
    assert np.asarray(ref.identity) == port.identity
    _same(port.combine(to_torch(a, "cpu"), to_torch(b, "cpu")).numpy(),
          ref.combine(jnp.asarray(a), jnp.asarray(b)))
    ids = rng.integers(0, 37, 500).astype(np.int32)
    acc, touched = segment_fold(to_torch(a, "cpu"),
                                torch.ones(500, dtype=torch.bool),
                                to_torch(ids, "cpu"), 40, "or")
    _same(acc.numpy(), ref.segment_fold(jnp.asarray(a), jnp.asarray(ids), 40))
    assert touched.numpy().tolist() == [i in set(ids) for i in range(40)]
    assert set(M.REGISTRY) == set(RM.REGISTRY)


def test_interop_carries_lane_state(layouts):
    """``[B, n_pad]`` leaves (uint32 included) cross unchanged."""
    L, _ = layouts
    rng = np.random.default_rng(4)
    state = {
        "vid": jnp.broadcast_to(jnp.arange(L.n_pad, dtype=jnp.uint32),
                                (3, L.n_pad)),
        "label": jnp.asarray(rng.integers(0, 2**32, (3, L.n_pad),
                                          dtype=np.uint64).astype(np.uint32)),
        "dist": jnp.asarray(rng.random((3, L.n_pad)).astype(np.float32)),
        "level": jnp.asarray(rng.integers(-1, 9, (3, L.n_pad), np.int32)),
        "active": jnp.asarray(rng.random((3, L.n_pad)) < 0.5)}
    got = state_to_torch(state, device="cpu")
    for key, v in state.items():
        assert tuple(got[key].shape) == (3, L.n_pad)
        _same(got[key].numpy(), v)
    _same(to_torch(state["label"], "cpu").numpy(), state["label"])


def test_batch_iter_stats_has_the_reference_fields():
    import dataclasses

    from repro.obs import schema as ref_schema
    from repro_torch.obs import BatchIterStats
    names = lambda cls: [(f.name, f.type) for f in dataclasses.fields(cls)]
    assert names(BatchIterStats) == names(ref_schema.BatchIterStats)

"""The port's dynamic graphs on the CPU against ``repro``'s.

``repro_torch.graph.delta`` is a NumPy copy of ``repro.graph.delta``: the
same edits give the same buffer contents and, through ``apply_delta``, the
same layout array for array, which is also a full ``build_layout`` of the
edited graph.  The resumed runs (``Engine.run(resume_from=, touched=)``,
``connected_components(resume_labels=)``) are bit-exact with the
reference's resumed runs and with cold runs on the new layout, on both DC
lowerings; ``pagerank(pr0=)`` is within 1e-6 of both.  The server's delta
swap evicts and migrates the same keys as the reference's and answers the
same afterwards.  Graphs are the reference delta tests' sizes: RMAT scale
8, weighted, ``k=8``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.graph as ref_graph
import repro_torch as rt
import repro_torch.graph as port_graph
from repro import obs as ref_obs
from repro.apps import pagerank as ref_pagerank
from repro.apps.bfs import bfs_seeded_pack as ref_seeded_pack
from repro.apps.bfs import bfs_seeded_program as ref_seeded_program
from repro.apps.cc import connected_components as ref_cc
from repro.apps.sssp import sssp_program as ref_sssp_program
from repro.apps.sssp_parents import sssp_parents_program as ref_sp_program
from repro.core.engine import Engine as RefEngine
from repro.serve import GraphQuery as RefQuery
from repro.serve import GraphQueryServer as RefServer
from repro.serve import ServeConfig as RefConfig
from repro_torch import obs
from repro_torch.apps.bfs import bfs_seeded_pack
from repro_torch.interop import layout_from_reference, packed_to_numpy
from repro_torch.serve import GraphQuery, GraphQueryServer, ServeConfig
from repro_torch.serve import cache as cache_lib
from torch_reference_shims import (same_bits, same_iter_stats,  # noqa: F401
                                   x64)

torch.set_num_threads(1)

LOWERINGS = ("fused", "composed")
PR_TOL = 1e-6


def _same_layout(a, b):
    """Every field of the Layout dataclass: equal dtype, shape, value."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if vb is None or isinstance(vb, (int, bool, np.integer)):
            assert va == vb, f.name
            continue
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
        assert np.array_equal(va, vb), f.name


def _random_ops(rng, n, count, insert_only=False, weighted=True):
    """A list of ("+", u, v, w) / ("-", u, v, None) edits, with repeated
    keys so that the last operation on a key has to win."""
    ops = []
    for _ in range(count):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if ops and rng.random() < 0.2:
            _, u, v, _ = ops[int(rng.integers(0, len(ops)))]
        if insert_only or rng.random() < 0.7:
            ops.append(("+", u, v,
                        float(rng.random() + 0.1) if weighted else None))
        else:
            ops.append(("-", u, v, None))
    return ops


def _buffer(graph_mod, layout, ops):
    d = graph_mod.DeltaBuffer.for_layout(layout)
    for op, u, v, w in ops:
        if op == "+":
            d.insert(u, v, w)
        else:
            d.delete(u, v)
    return d


def _sym_ops(rng, n, count):
    ops = []
    for _ in range(count):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        w = float(rng.random() + 0.05)
        ops += [("+", u, v, w), ("+", v, u, w)]
    return ops


@pytest.fixture
def lowering(request, monkeypatch):
    """``REPRO_FUSED`` for both packages' engines built in the test."""
    monkeypatch.setenv("REPRO_FUSED", "1" if request.param == "fused" else "0")
    return request.param


@pytest.fixture(scope="module")
def sym_pair():
    """(old, new) layouts of both packages and the delta of each: the
    reference resume tests' symmetric graph and six symmetric inserts."""
    g = ref_graph.symmetrize(ref_graph.rmat(8, 8, seed=3, weighted=True))
    return _pair(g, _sym_ops(np.random.default_rng(5), g.n, 6))


@pytest.fixture(scope="module")
def directed_pair():
    """The same, on the directed graph with 24 random inserts."""
    g = ref_graph.rmat(8, 8, seed=3, weighted=True)
    return _pair(g, _random_ops(np.random.default_rng(6), g.n, 24,
                                insert_only=True))


def _pair(g, ops):
    L = ref_graph.build_layout(g, k=8, edge_tile=64, msg_tile=32)
    TL = layout_from_reference(L)
    d_ref, d = _buffer(ref_graph, L, ops), _buffer(port_graph, TL, ops)
    L2, TL2 = ref_graph.apply_delta(L, d_ref), port_graph.apply_delta(TL, d)
    _same_layout(TL2, L2)
    return dict(L=L, TL=TL, L2=L2, TL2=TL2, d_ref=d_ref, d=d, ops=ops)


# ----------------------------------------------------------------------
# DeltaBuffer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_delta_buffer_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = port_graph.rmat(7, 6, seed=seed, weighted=True)
    TL = port_graph.build_layout(g, k=4, edge_tile=16, msg_tile=8)
    L = ref_graph.build_layout(ref_graph.rmat(7, 6, seed=seed,
                                              weighted=True),
                               k=4, edge_tile=16, msg_tile=8)
    ops = _random_ops(rng, g.n, 40)
    d, d_ref = _buffer(port_graph, TL, ops), _buffer(ref_graph, L, ops)
    assert (len(d), bool(d), d.num_inserts, d.num_deletes,
            d.insertions_only) == (len(d_ref), bool(d_ref),
                                   d_ref.num_inserts, d_ref.num_deletes,
                                   d_ref.insertions_only)
    for got, want in zip(d.inserts() + d.deletes(),
                         d_ref.inserts() + d_ref.deletes()):
        same_bits(got, want)
    for name in ("src_partitions", "dst_partitions", "dirty_partitions",
                 "touched"):
        same_bits(getattr(d, name)(), getattr(d_ref, name)())
    got, want = d.edit_graph(g), d_ref.edit_graph(
        ref_graph.rmat(7, 6, seed=seed, weighted=True))
    for name in ("indptr", "indices", "weights"):
        same_bits(getattr(got, name), getattr(want, name))
    # last operation wins: a deleted then reinserted edge is one insert
    last = rt.DeltaBuffer.for_layout(TL)
    last.insert(0, 1, 2.0).delete(0, 1).insert(0, 1, 7.0)
    assert len(last) == 1 and last.num_inserts == 1
    assert list(last.inserts()[2]) == [7.0]


@pytest.mark.parametrize("case", ["dst_range", "src_negative", "lengths",
                                  "partitioning", "weights_needed",
                                  "graph_size", "apply_partitioning"])
def test_delta_checks_match_reference(case):
    g = ref_graph.from_edges([0, 1, 2], [1, 2, 0], n=6,
                             weights=np.asarray([1., 2., 3.], np.float32))
    for G in (ref_graph, port_graph):
        L = G.build_layout(g, k=2, edge_tile=8, msg_tile=8)
        d = G.DeltaBuffer.for_layout(L)
        calls = {
            "dst_range": lambda: d.insert(0, L.n),
            "src_negative": lambda: d.delete(-1, 0),
            "lengths": lambda: d.insert([0, 1], [2]),
            "partitioning": lambda: G.DeltaBuffer(k=2, q=2, n=6),
            "weights_needed": lambda: d.insert(0, 3).edit_graph(g),
            "graph_size": lambda: d.edit_graph(
                ref_graph.from_edges([0], [1], n=5)),
            "apply_partitioning": lambda: G.apply_delta(
                L, G.DeltaBuffer(k=3, q=L.q, n=L.n)),
        }
        with pytest.raises(ValueError):
            calls[case]()


# ----------------------------------------------------------------------
# apply_delta == the reference's == a full rebuild
# ----------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_apply_delta_matches_reference_and_rebuild(weighted):
    rng = np.random.default_rng(21 + weighted)
    for _ in range(10):
        n = int(rng.integers(1, 60))
        m = int(rng.integers(0, 4 * n + 1))
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        w = rng.random(m).astype(np.float32) + 0.1 if weighted else None
        g = ref_graph.from_edges(src, dst, n=n, weights=w)
        geo = dict(k=int(rng.integers(1, 9)),
                   edge_tile=int(rng.choice([1, 4, 16])),
                   msg_tile=int(rng.choice([1, 2, 8])))
        L = ref_graph.build_layout(g, **geo)
        TL = port_graph.build_layout(g, **geo)
        _same_layout(TL, L)
        ops = _random_ops(rng, n, int(rng.integers(1, 12)),
                          weighted=weighted)
        d = _buffer(port_graph, TL, ops)
        got = port_graph.apply_delta(TL, d)
        _same_layout(got, ref_graph.apply_delta(L, _buffer(ref_graph, L,
                                                           ops)))
        _same_layout(got, port_graph.build_layout(
            d.edit_graph(g), k=TL.k, edge_tile=TL.edge_tile,
            msg_tile=TL.msg_tile, fold_tile=TL.fold_tile, fold_q=TL.fold_q))


def test_apply_delta_empty_is_identity_and_event_matches(sym_pair):
    TL = sym_pair["TL"]
    _same_layout(port_graph.apply_delta(TL, rt.DeltaBuffer.for_layout(TL)),
                 TL)
    events = {}
    for name, G, lay, o in (("port", port_graph, TL, obs),
                            ("ref", ref_graph, sym_pair["L"], ref_obs)):
        with o.override_enabled(True):
            o.reset()
            G.apply_delta(lay, _buffer(G, lay, sym_pair["ops"]))
            events[name] = o.events("delta_apply")
            o.reset()
    assert len(events["port"]) == 1
    assert obs.validate_event(events["port"][0]) == []
    drop = lambda e: {k: v for k, v in e.items() if k not in ("ts", "wall_s")}
    assert [drop(e) for e in events["port"]] == [drop(e)
                                                 for e in events["ref"]]


# ----------------------------------------------------------------------
# resume from the old fixpoint
# ----------------------------------------------------------------------

def _port_start(app, n_pad, src):
    """The port's program and cold state for ``app`` from ``src``."""
    frontier = np.zeros(n_pad, bool)
    frontier[src] = True
    vid = torch.arange(n_pad, dtype=torch.int32).view(torch.uint32)
    if app == "bfs":
        level = torch.full((n_pad,), -1, dtype=torch.int32)
        level[src] = 0
        parent = torch.full((n_pad,), src, dtype=torch.int32)
        return rt.apps.bfs_seeded_program(), {
            "best": bfs_seeded_pack(level, parent), "vid": vid}, frontier
    dist = torch.full((n_pad,), float("inf"))
    dist[src] = 0.0
    if app == "sssp":
        return rt.apps.sssp_program(), {"dist": dist}, frontier
    parent = torch.full((n_pad,), -1, dtype=torch.int32)
    parent[src] = src
    return rt.apps.sssp_parents_program(), {
        "dist": dist, "parent": parent, "vid": vid}, frontier


def _ref_start(app, n_pad, src):
    """The reference's program and cold state (inside an x64 context)."""
    import jax.numpy as jnp
    frontier = np.zeros(n_pad, bool)
    frontier[src] = True
    vid = jnp.arange(n_pad, dtype=jnp.uint32)
    if app == "bfs":
        level = np.full(n_pad, -1, np.int32)
        level[src] = 0
        return ref_seeded_program(), {
            "best": ref_seeded_pack(level, np.full(n_pad, src)),
            "vid": vid}, frontier
    dist = jnp.full((n_pad,), jnp.inf, jnp.float32).at[src].set(0.0)
    if app == "sssp":
        return ref_sssp_program(), {"dist": dist}, frontier
    parent = jnp.full((n_pad,), -1, jnp.int32).at[src].set(src)
    return ref_sp_program(), {
        "dist": dist, "parent": parent, "vid": vid}, frontier


def _port_bits(state):
    return {k: packed_to_numpy(v) if v.dtype == torch.int64
            else v.numpy() for k, v in state.items()}


@pytest.mark.parametrize("mode", ["hybrid", "dc"])
@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
@pytest.mark.parametrize("app", ["bfs", "sssp", "sssp_parents"])
def test_resume_matches_reference_and_cold(directed_pair, app, lowering,
                                           mode):
    p = directed_pair
    src = int(np.argmax(p["L"].deg[:p["L"].n]))
    n_pad = p["TL"].n_pad
    prog, state0, frontier = _port_start(app, n_pad, src)
    old, _, _ = rt.Engine(p["TL"], prog, mode=mode, device="cpu").run(
        state0, frontier)
    eng = rt.Engine(p["TL2"], prog, mode=mode, device="cpu")
    assert eng.fused == (lowering == "fused")
    warm, _, warm_stats = eng.run(resume_from=old, touched=p["d"])
    cold, _, _ = eng.run(dict(state0), frontier)
    with jax.enable_x64(True):
        rprog, rstate0, _ = _ref_start(app, n_pad, src)
        rold, _, _ = RefEngine(p["L"], rprog, mode=mode).run(rstate0,
                                                             frontier)
        rwarm, _, rstats = RefEngine(p["L2"], rprog, mode=mode).run(
            resume_from=rold, touched=p["d_ref"])
        rwarm = {k: np.asarray(v) for k, v in rwarm.items()}
    got, cold = _port_bits(warm), _port_bits(cold)
    for key, want in rwarm.items():
        same_bits(got[key], want)
        same_bits(got[key], cold[key])
    same_iter_stats(warm_stats, rstats)


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
@pytest.mark.parametrize("touched", ["buffer", "mask"])
def test_cc_resume_matches_reference_and_cold(sym_pair, lowering, touched):
    p = sym_pair
    old = rt.connected_components(p["TL"], device="cpu")
    cold = rt.connected_components(p["TL2"], device="cpu")
    t = p["d"] if touched == "buffer" else p["d"].touched()
    warm = rt.connected_components(p["TL2"], device="cpu",
                                   resume_labels=old["label"], touched=t)
    ref_old = ref_cc(p["L"])
    ref_t = p["d_ref"] if touched == "buffer" else p["d_ref"].touched()
    ref_warm = ref_cc(
        p["L2"], resume_labels=ref_old["label"], touched=ref_t)
    same_bits(warm["label"], ref_warm["label"])
    same_bits(warm["label"], cold["label"])
    same_iter_stats(warm["stats"], ref_warm["stats"])
    assert len(warm["stats"]) <= len(cold["stats"])


@pytest.mark.parametrize("fused", [True, False])
def test_pagerank_warm_start_within_1e6(sym_pair, fused):
    p = sym_pair
    old = rt.pagerank(p["TL"], iters=120, device="cpu")["pr"]
    want = rt.pagerank(p["TL2"], iters=160, device="cpu")["pr"]
    warm = rt.pagerank(p["TL2"], iters=60, pr0=old, fused=fused,
                       device="cpu")["pr"]
    ref_old = ref_pagerank(p["L"], iters=120)["pr"]
    ref_warm = ref_pagerank(p["L2"], iters=60, pr0=ref_old)["pr"]
    assert np.abs(warm - want).max() <= PR_TOL
    assert np.abs(warm - ref_warm).max() <= PR_TOL
    # an [n_pad] start carries its pads too
    padded = np.full(p["TL"].n_pad, 0.5, np.float32)
    padded[:p["TL"].n] = old
    same_bits(rt.pagerank(p["TL2"], iters=60, pr0=padded, fused=fused,
                          device="cpu")["pr"],
              rt.pagerank(p["TL2"], iters=60, pr0=old, fused=fused,
                          device="cpu")["pr"])


@pytest.mark.parametrize("case", ["cc_deletion", "engine_deletion",
                                  "not_idempotent", "state_and_resume",
                                  "resume_without_touched", "cc_pairing",
                                  "nothing"])
def test_resume_refusals(sym_pair, case):
    p = sym_pair
    TL2, n_pad = p["TL2"], p["TL2"].n_pad
    ddel = rt.DeltaBuffer.for_layout(TL2).insert(0, 1, 1.0).delete(1, 0)
    labels = torch.arange(n_pad, dtype=torch.int32).view(torch.uint32)
    cc = rt.Engine(TL2, rt.apps.cc_program(), device="cpu")
    pr = rt.Engine(TL2, rt.apps.pagerank_program(TL2.n), mode="dc",
                   device="cpu")
    calls = {
        "cc_deletion": (lambda: rt.connected_components(
            TL2, device="cpu", resume_labels=np.zeros(TL2.n, np.uint32),
            touched=ddel), "insertion-only"),
        "engine_deletion": (lambda: cc.run(resume_from={"label": labels},
                                           touched=ddel), "insertion-only"),
        "not_idempotent": (lambda: pr.run(
            resume_from={"pr": torch.zeros(n_pad)}, touched=p["d"]),
            "idempotent"),
        "state_and_resume": (lambda: cc.run(
            {"label": labels}, resume_from={"label": labels},
            touched=p["d"]), "not both"),
        "resume_without_touched": (lambda: cc.run(
            resume_from={"label": labels}), "needs touched"),
        "cc_pairing": (lambda: rt.connected_components(
            TL2, device="cpu", resume_labels=np.zeros(4, np.uint32)),
            "go together"),
        "nothing": (lambda: cc.run(), "state\\+frontier"),
    }
    fn, match = calls[case]
    with pytest.raises(ValueError, match=match):
        fn()


# ----------------------------------------------------------------------
# the server's delta swap
# ----------------------------------------------------------------------

def _drain(srv, cls, app, sources, qid0=0):
    for i, s in enumerate(sources):
        srv.submit(cls(qid=qid0 + i, app=app, params={"source": int(s)}))
    return {int(q.params["source"]): q.result for q in srv.run()}


def _swap_pair(insert_only):
    """The reference epoch tests' delta: four symmetric inserts, and with
    ``insert_only=False`` the deletion of a real symmetric pair."""
    g = ref_graph.symmetrize(ref_graph.rmat(8, 8, seed=3, weighted=True))
    ops = _sym_ops(np.random.default_rng(5), g.n, 4)
    if not insert_only:
        u = int(g.indices[0])
        ops += [("-", 0, u, None), ("-", u, 0, None)]
    return _pair(g, ops)


def _same_results(got, want):
    assert got.keys() == want.keys()
    for s, res in want.items():
        for key, value in res.items():
            if key != "stats":
                same_bits(got[s][key], value)


@pytest.mark.parametrize("insert_only", [True, False])
def test_swap_layout_delta_matches_reference(x64, insert_only):
    p = _swap_pair(insert_only)
    with obs.override_enabled(True), ref_obs.override_enabled(True):
        obs.reset()
        ref_obs.reset()
        ref = RefServer(p["L"], RefConfig(backend="ref", cache_size=64))
        port = GraphQueryServer(p["TL"], ServeConfig(cache_size=64),
                                device="cpu")
        before = {}
        for name, srv, cls in (("ref", ref, RefQuery),
                               ("port", port, GraphQuery)):
            before[name] = (_drain(srv, cls, "sssp", [5, 9]),
                            _drain(srv, cls, "bfs", [5, 9], qid0=10))
        assert port.cache.keys() == ref.cache.keys()
        old_tag = port._layout_tag
        ref.swap_layout(p["L2"], delta=p["d_ref"])
        port.swap_layout(p["TL2"], delta=p["d"])
        assert port.epoch == ref.epoch == 1
        assert port._layout_tag == ref._layout_tag != old_tag
        assert port.cache.keys() == ref.cache.keys()
        assert not any(f"|{old_tag}|" in k for k in port.cache.keys())
        drop = lambda e: {k: v for k, v in e.items() if k != "ts"}
        ev, ref_ev = obs.events("epoch_swap"), ref_obs.events("epoch_swap")
        assert [drop(e) for e in ev] == [drop(e) for e in ref_ev]
        assert ev[-1]["delta"] is True and obs.validate_event(ev[-1]) == []
        assert ev[-1]["evicted"] + ev[-1]["migrated"] > 0
        if not insert_only:
            assert ev[-1]["migrated"] == 0
        after = {}
        for name, srv, cls in (("ref", ref, RefQuery),
                               ("port", port, GraphQuery)):
            after[name] = (_drain(srv, cls, "sssp", [5, 77], qid0=20),
                           _drain(srv, cls, "bfs", [5, 77], qid0=30))
        obs.reset()
        ref_obs.reset()
    for got, want in zip(before["port"] + after["port"],
                         before["ref"] + after["ref"]):
        _same_results(got, want)
    # on the new graph the answers are the apps' own
    cold = rt.bfs_multi(p["TL2"], [5, 77], device="cpu")
    for i, s in enumerate((5, 77)):
        same_bits(after["port"][1][s]["level"], cold["level"][i])


def test_delta_swap_migrates_exactly_the_clean_landmarks(x64):
    """The reference's count (tests/test_delta.py): every old-tag landmark
    whose partitions the delta left unchanged is re-keyed, the rest go."""
    p = _swap_pair(True)
    srv = GraphQueryServer(p["TL"], ServeConfig(cache_size=64),
                           device="cpu")
    _drain(srv, GraphQuery, "sssp", [5, 9])
    old_tag = srv._layout_tag
    changed = {i for i, (a, b) in enumerate(zip(
        cache_lib.partition_tags(p["TL"]), cache_lib.partition_tags(
            p["TL2"]))) if a != b}
    clean = sum(1 for k in srv.cache.keys()
                if k.startswith(f"sem|{old_tag}|")
                and not set(np.asarray(srv.cache.get(k)["parts"]).tolist())
                & changed)
    srv.swap_layout(p["TL2"], delta=p["d"])
    assert sum(1 for k in srv.cache.keys()
               if k.startswith(f"sem|{srv._layout_tag}|")) == clean


def test_close_the_loop_end_to_end(x64, tmp_path):
    """Serve on epoch 0, apply a delta, swap with scoped invalidation, and
    serve exact answers on the new graph (migrated landmarks included),
    on a disk cache."""
    p = _swap_pair(True)
    srv = GraphQueryServer(
        p["TL"], ServeConfig(cache_backend=str(tmp_path / "e2e"),
                             cache_size=64), device="cpu")
    _drain(srv, GraphQuery, "sssp", [5, 9])
    srv.swap_layout(p["TL2"], delta=p["d"])
    got = _drain(srv, GraphQuery, "sssp", [5], qid0=40)
    want = rt.sssp_multi(p["TL2"], [5], device="cpu")["dist"][0]
    fin = np.isfinite(want)
    assert np.array_equal(np.isinf(got[5]["dist"]), np.isinf(want))
    assert np.abs(got[5]["dist"][fin] - want[fin]).max() <= PR_TOL

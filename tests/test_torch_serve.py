"""The port's graph query server on the CPU against ``repro``'s.

Both servers get the same layout and the same query stream, in rounds: BFS,
SSSP and SSSP-with-parents queries over a few sources with repeats (so
later rounds hit the exact-result cache, run landmark-seeded, and feed the
warmer), then CC and PageRank on the single-query path.  They must give
equal answers (PageRank within L1 1e-6: f32 adds in another order), equal
hit / miss / semantic counters, the same batch widths, the same cache keys
and the same layout tag.  The reference runs on its ``ref`` backend under
the x64 shim (``torch_reference_shims``).  The layout is the reference
serving tests' graph, symmetrized (seeding needs symmetry): RMAT scale 8,
weighted, ``k=8``.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import Engine as RefEngine
from repro.graph import build_layout, rmat, symmetrize
from repro.serve import GraphQuery as RefQuery
from repro.serve import GraphQueryServer as RefServer
from repro.serve import ServeConfig as RefConfig
from repro_torch import obs
from repro_torch.core.engine import Engine
from repro_torch.graph import DeltaBuffer
from repro_torch.interop import layout_from_reference
from repro_torch.serve import GraphQuery, GraphQueryServer, ServeConfig
from torch_reference_shims import same_bits, x64  # noqa: F401

torch.set_num_threads(1)

PR_L1 = 1e-6


@pytest.fixture(scope="module")
def layouts():
    g = rmat(8, 8, seed=3, weighted=True)
    out = {}
    for name, graph in (("symmetric", symmetrize(g)), ("directed", g)):
        L = build_layout(graph, k=8, edge_tile=64, msg_tile=32)
        out[name] = (L, layout_from_reference(L))
    return out


@pytest.fixture
def widths(monkeypatch):
    """The lane count of every ``run_batched`` call, per package."""
    seen = {"port": [], "reference": []}
    for name, cls in (("port", Engine), ("reference", RefEngine)):
        orig = cls.run_batched

        def spy(self, states, frontiers, *a, _orig=orig, _name=name, **kw):
            seen[_name].append(int(np.asarray(frontiers).shape[0]))
            return _orig(self, states, frontiers, *a, **kw)

        monkeypatch.setattr(cls, "run_batched", spy)
    return seen


def _rounds(n, seed=0, rounds=3):
    """Rounds of (qid, app, params): 4 BFS, 4 SSSP and 2 SSSP-with-parents
    queries over 6 sources with repeats, then a CC and a PageRank query."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(n, 6, replace=False)
    out, qid = [], 0
    for _ in range(rounds):
        batch = []
        for app, count in (("bfs", 4), ("sssp", 4), ("sssp_parents", 2)):
            for s in rng.choice(pool, count):
                batch.append((qid, app, {"source": int(s)}))
                qid += 1
        out.append(batch)
    out.append([(qid, "cc", {}), (qid + 1, "pagerank", {"iters": 5})])
    return out


def _serve(server, query_cls, rounds):
    done = {}
    for batch in rounds:
        for qid, app, params in batch:
            server.submit(query_cls(qid, app, dict(params)))
        done.update({q.qid: q.result for q in server.run()})
    return done


def _same_answers(port, ref):
    assert port.keys() == ref.keys()
    for qid, want in ref.items():
        got = port[qid]
        assert got.keys() == want.keys()
        for key, value in want.items():
            if key == "stats":
                continue
            if key == "pr":
                assert np.abs(np.asarray(value, np.float64)
                              - got[key]).sum() <= PR_L1
            else:
                same_bits(got[key], value)


def _counters(srv):
    return (srv.cache_hits, srv.cache_misses, srv.semantic_hits,
            srv.semantic_misses, srv.epoch)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_server_matches_reference(x64, layouts, widths, monkeypatch, fused):
    monkeypatch.setenv("REPRO_FUSED", fused)
    L, TL = layouts["symmetric"]
    rounds = _rounds(L.n)
    obs.reset()
    ref = RefServer(L, RefConfig(backend="ref"))
    port = GraphQueryServer(TL, ServeConfig(), device="cpu")
    want = _serve(ref, RefQuery, rounds)
    got = _serve(port, GraphQuery, rounds)
    _same_answers(got, want)
    assert _counters(port) == _counters(ref)
    assert port.semantic_hits > 0 and port.cache_hits > 0
    assert widths["port"] == widths["reference"]
    assert port._layout_tag == ref._layout_tag
    assert port.cache.keys() == ref.cache.keys()
    assert list(port._engines) == list(ref._engines)
    assert all(e.fused == (fused == "1") for e in port._engines.values())
    # what the port's obs recorded: valid events, one per batch (the
    # warmer's runs have none), and a latency histogram per app
    events = obs.events()
    assert events and all(obs.validate_event(e) == [] for e in events)
    calls = iter(widths["port"])
    assert all(e["width"] in calls for e in events
               if e["event"] == "serve_batch")
    assert any(e["event"] == "seeded_batch" for e in events)
    hists = obs.snapshot()["histograms"]
    for app in ("bfs", "sssp", "sssp_parents", "cc", "pagerank"):
        key = f"serve.query_wall_s{{app={app},layout={port._layout_tag}}}"
        assert hists[key]["count"] > 0


def test_swap_layout_without_delta_matches_reference(x64, layouts):
    """A -> B -> A: nothing is evicted, so A's entries hit again after the
    second swap; the epoch counts swaps; queued queries drain first."""
    (A, TA), (B, TB) = layouts["symmetric"], layouts["directed"]
    rounds = _rounds(A.n, seed=1, rounds=1)
    ref = RefServer(A, RefConfig(backend="ref"))
    port = GraphQueryServer(TA, ServeConfig(), device="cpu")
    for srv, cls, (first, second) in ((ref, RefQuery, (A, B)),
                                      (port, GraphQuery, (TA, TB))):
        _serve(srv, cls, rounds)
        srv.submit(cls(99, "bfs", {"source": 1}))
        srv.swap_layout(second)                  # drains query 99 on A
        assert not srv.queue
    answers = {}
    for name, srv, cls, first in (("ref", ref, RefQuery, A),
                                  ("port", port, GraphQuery, TA)):
        on_b = _serve(srv, cls, rounds)
        srv.swap_layout(first)
        answers[name] = (on_b, _serve(srv, cls, rounds))
    _same_answers(answers["port"][0], answers["ref"][0])
    _same_answers(answers["port"][1], answers["ref"][1])
    assert _counters(port) == _counters(ref)
    assert port.epoch == 2 and port.cache_misses == 0
    assert port.cache.keys() == ref.cache.keys()


def test_single_query_overrides_match_reference(x64, layouts):
    """Queries that override the engine (mode, bw_ratio, the ``ref``
    backend) take an engine of their own; Nibble and BFS with a
    non-batchable param take the single-query path."""
    L, TL = layouts["symmetric"]
    queries = [(0, "bfs", {"source": 3, "mode": "dc"}),
               (1, "sssp", {"source": 3, "bw_ratio": 1.0}),
               (2, "sssp_parents", {"source": 5, "mode": "sc"}),
               (3, "cc", {"backend": "ref"}),
               (4, "nibble", {"seeds": [3], "eps": 1e-4, "max_iters": 20}),
               (5, "pagerank", {"iters": 3, "damping": 0.8, "mode": "dc"}),
               (6, "sssp_parents", {"source": 5})]
    ref = RefServer(L, RefConfig(backend="ref"))
    port = GraphQueryServer(TL, ServeConfig(), device="cpu")
    _same_answers(_serve(port, GraphQuery, [queries]),
                  _serve(ref, RefQuery, [queries]))
    assert _counters(port) == _counters(ref)
    assert list(port._engines) == list(ref._engines) == ["sssp_parents"]


def test_paths_not_ported_raise(layouts):
    """Every path of the reference's server is ported; what it refuses, the
    port refuses alike: distributed serving needs both ``sharded`` and
    ``mesh`` (or neither), at construction and at a swap, and a delta of
    another partitioning."""
    _, TL = layouts["symmetric"]
    for half in (dict(sharded=object()), dict(mesh=object())):
        with pytest.raises(ValueError, match="BOTH sharded and mesh"):
            GraphQueryServer(TL, ServeConfig(**half), device="cpu")
    srv = GraphQueryServer(TL, ServeConfig(), device="cpu")
    with pytest.raises(ValueError, match="delta partitioning does not match"):
        srv.swap_layout(TL, delta=DeltaBuffer(k=TL.k + 1, q=TL.q, n=TL.n))
    for half in (dict(sharded=object()), dict(mesh=object())):
        with pytest.raises(ValueError, match="BOTH sharded and mesh"):
            srv.swap_layout(TL, **half)
    assert srv.epoch == 0
    with pytest.raises(ValueError, match="backend"):
        GraphQueryServer(TL, ServeConfig(backend="pallas"), device="cpu")


def test_server_runs_on_a_card_by_default(layouts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, TL = layouts["symmetric"]
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphQueryServer(TL)


def test_seeded_sssp_follows_the_reference_below_the_cold_run(x64):
    """Landmark-seeded SSSP is exact in real arithmetic only.  Its seed
    ``fl(d_L(v) + d_L(s))`` can round below the cold run's f32 path sum,
    and relaxation never raises a value: on this graph one seeded answer
    ends one ulp under the cold run, in the reference's server and, bit for
    bit, in the port's."""
    from repro.apps import sssp as ref_sssp
    from repro_torch.apps import sssp as rt_sssp
    from repro_torch.apps import sssp_program as rt_sssp_program
    g = symmetrize(rmat(14, 16, seed=0, weighted=True))
    L = build_layout(g, k=16, edge_tile=64, msg_tile=32)
    TL = layout_from_reference(L)
    rng = np.random.default_rng(0)
    pool = rng.choice(L.n, 24, replace=False)
    rounds = [[(r * 16 + i, "sssp", {"source": int(s)})
               for i, s in enumerate(rng.choice(pool, 16))]
              for r in range(3)]
    ref = _serve(RefServer(L, RefConfig(backend="ref")), RefQuery, rounds)
    port = _serve(GraphQueryServer(TL, ServeConfig(), device="cpu"),
                  GraphQuery, rounds)
    _same_answers(port, ref)
    source = {qid: p["source"] for batch in rounds for qid, _, p in batch}
    # the cold runs: the port's (bit-exact with the reference's cold SSSP,
    # tests/test_torch_apps.py), and the reference's own where they differ
    eng = Engine(TL, rt_sssp_program(), device="cpu")
    cold = {s: rt_sssp(TL, s, engine=eng)["dist"]
            for s in set(source.values())}
    same_bits(cold[10990], ref_sssp(L, 10990, backend="ref")["dist"])
    below = []
    for qid, res in port.items():
        got, cold_d = res["dist"], cold[source[qid]]
        if not np.array_equal(got, cold_d):
            fin = np.isfinite(cold_d)
            assert np.array_equal(np.isfinite(got), fin)
            assert np.all(got[fin] <= cold_d[fin])
            d = got != cold_d
            assert np.all(np.nextafter(got[d], np.float32(np.inf))
                          == cold_d[d])
            below.append(source[qid])
    assert set(below) == {10990}

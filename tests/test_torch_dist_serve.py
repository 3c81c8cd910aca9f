"""Sharded serving: the port's ``GraphQueryServer`` over
``ServeConfig(sharded=, mesh=)`` on 1 and 2 gloo ranks
(``tests/torch_dist_ranks.py``, scenario ``serve``) against the reference's
unsharded server on the same queries.

Every rank runs the same server on the same queries; each answer equals the
reference server's (``repro.serve.GraphQueryServer`` on its ``ref``
backend, no semantic seeding, under the x64 shim; bit-exact, PageRank within
L1 1e-6).  The sharded shared engines are ``DistEngine``s, a repeated query
is an exact-cache hit, no lane is seeded from a landmark, and
``swap_layout(sharded=, mesh=, delta=)`` to the layout of an insertion-only
delta starts a new epoch whose answers equal the reference server's on the
reference's ``apply_delta`` of the same delta.
"""
import numpy as np
import pytest
import torch

import repro.graph as ref_graph
from repro.serve import GraphQuery as RefQuery
from repro.serve import GraphQueryServer as RefServer
from repro.serve import ServeConfig as RefConfig
from torch_dist_ranks import Ranks, serve_queries
from torch_reference_shims import patch_x64, same_bits

torch.set_num_threads(1)

RANKS = (1, 2)
ARGS = dict(scale=9, seed=3, k=8)
TILES = dict(k=ARGS["k"], edge_tile=64, msg_tile=32)


def _args():
    g = ref_graph.symmetrize(ref_graph.rmat(ARGS["scale"], 8,
                                            seed=ARGS["seed"], weighted=True))
    rng = np.random.default_rng(7)
    hub = int(np.argmax(g.out_degrees()))
    pick = lambda n: [hub] + [int(s) for s in rng.choice(g.n, n - 1,
                                                         replace=False)]
    sources = [(pick(4), pick(3), pick(2)), (pick(3), pick(3), pick(2))]
    u = rng.integers(0, g.n, 40)
    v = rng.integers(0, g.n, 40)
    w = rng.integers(1, 9, 40).astype(np.float32)
    inserts = (np.concatenate([u, v]), np.concatenate([v, u]),
               np.concatenate([w, w]))
    return dict(ARGS, sources=sources, inserts=inserts)


def _reference_answers(args):
    """The same rounds on the reference's unsharded server (no semantic
    seeding, so every answer is the cold one), on the reference's layout
    before and after the delta."""
    g = ref_graph.rmat(args["scale"], 8, seed=args["seed"], weighted=True)
    L = ref_graph.build_layout(ref_graph.symmetrize(g), **TILES)
    L2 = ref_graph.apply_delta(L, ref_graph.DeltaBuffer.for_layout(L).insert(
        *args["inserts"]))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_x64(mp)
        for round_no, lay in enumerate((L, L2)):
            srv = RefServer(lay, RefConfig(backend="ref", semantic=False))
            for qid, app, params in serve_queries(args, round_no):
                srv.submit(RefQuery(qid, app, dict(params)))
            out.update({q.qid: q.result for q in srv.run()})
    return out, (L.n, L.k, L.q)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    args = _args()
    ranks = {D: Ranks("serve", D, tmp_path_factory.mktemp(f"serve{D}"),
                      dict(args, D=D))
             for D in RANKS}
    want = _reference_answers(args)
    return args, want, {D: r.results() for D, r in ranks.items()}


def _query_ids(args):
    return [(qid, app) for r in (0, 1) for qid, app, _ in
            serve_queries(args, r)]


@pytest.mark.parametrize("round_no", [0, 1])
@pytest.mark.parametrize("app", ["bfs", "sssp", "sssp_parents", "cc",
                                 "pagerank"])
@pytest.mark.parametrize("D", RANKS)
def test_sharded_answers_match_unsharded(served, D, app, round_no):
    args, (want, shape), ranks = served
    qids = [qid for qid, a, _ in serve_queries(args, round_no) if a == app]
    assert qids
    for res in ranks[D]:
        assert (res["n"], res["k"], res["q"]) == shape
        for qid in qids:
            got, ref = res["answers"][qid], want[qid]
            assert got.keys() == {k for k in ref if k != "stats"}
            for key in got:
                if app == "pagerank":
                    assert np.abs(got[key].astype(np.float64)
                                  - np.asarray(ref[key], np.float64)
                                  ).sum() <= 1e-6
                else:
                    same_bits(got[key], ref[key])


@pytest.mark.parametrize("D", RANKS)
def test_sharded_server_shares_dist_engines_and_caches(served, D):
    args, _, ranks = served
    for res in ranks[D]:
        assert res["engines"] == [("bfs", "DistEngine"),
                                  ("cc", "DistEngine"),
                                  ("sssp", "DistEngine"),
                                  ("sssp_parents", "DistEngine")]
        assert res["cache_hits"] >= 1
        assert res["semantic_hits"] == 0
        first = serve_queries(args, 0)[0][0]
        for key, v in res["answers"][99].items():
            assert np.array_equal(v, res["answers"][first][key])


@pytest.mark.parametrize("D", RANKS)
def test_sharded_swap_layout_with_delta(served, D):
    _, _, ranks = served
    for res in ranks[D]:
        assert res["swapped"] == dict(epoch=1, engines=0, sharded_d=D,
                                      mesh_is_ours=True)

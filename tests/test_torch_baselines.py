"""The port's vertex-centric baselines (``repro_torch.baselines.vc``) on the
CPU against ``repro.baselines.vc`` on the same graphs.

BFS (push, pull, edge-centric), SSSP and CC bit-exact: min folds are exact
in any order.  PageRank within 1e-6, the reference's own tolerance for f32
adds summed in another order (``tests/test_apps.py``).
"""
import numpy as np
import pytest
import torch

import repro.baselines.vc as ref_vc
from repro.graph import from_edges, grid2d, rmat, star, symmetrize
from repro_torch.baselines import vc

torch.set_num_threads(1)


def _isolated():
    """Two components and an isolated vertex (never reached)."""
    src = np.array([0, 1, 2, 4, 5], np.int32)
    dst = np.array([1, 2, 0, 5, 4], np.int32)
    return from_edges(src, dst, n=7,
                      weights=np.array([.5, .25, 2., 1., 1.], np.float32))


GRAPHS = {
    "rmat": lambda: rmat(9, 8, seed=1, weighted=True),
    "rmat_sym": lambda: symmetrize(rmat(8, 8, seed=2, weighted=True)),
    "grid": lambda: grid2d(12, 9, weighted=True),
    "star": lambda: star(64),
    "isolated": _isolated,
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    g = GRAPHS[request.param]()
    return g, int(np.argmax(g.out_degrees()))


@pytest.mark.parametrize("fn", ["bfs_push", "bfs_pull", "bfs_ec"])
def test_bfs_bit_exact(graph, fn):
    g, src = graph
    want = getattr(ref_vc, fn)(g, src)
    got = getattr(vc, fn)(g, src, device="cpu")
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_sssp_bit_exact(graph):
    g, src = graph
    if g.weights is None:
        g = type(g)(g.indptr, g.indices,
                    np.linspace(0.1, 1.0, g.m).astype(np.float32))
    want = ref_vc.sssp_push(g, src)
    got = vc.sssp_push(g, src, device="cpu")
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_sssp_needs_weights():
    with pytest.raises(ValueError, match="weighted"):
        vc.sssp_push(star(8), 0, device="cpu")


def test_cc_bit_exact(graph):
    g, _ = graph
    want = ref_vc.cc_ec(g)
    got = vc.cc_ec(g, device="cpu")
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("iters,damping", [(10, 0.85), (3, 0.5)])
def test_pagerank_within_1e6(graph, iters, damping):
    g, _ = graph
    want = ref_vc.pagerank_spmv(g, iters=iters, damping=damping)
    got = vc.pagerank_spmv(g, iters=iters, damping=damping, device="cpu")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_timed_returns_the_last_result():
    g = rmat(6, 4, seed=0)
    wall, out = vc.timed(vc.bfs_push, g, 0, repeat=2, device="cpu")
    assert wall > 0
    assert np.array_equal(out, ref_vc.bfs_push(g, 0))

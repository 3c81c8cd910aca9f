"""The port's apps on the CPU against ``repro.apps``, on one layout.

Both packages get the same layout (the reference's, carried across by
``repro_torch.interop.layout_from_reference``) and are compared under both
reference backends, ``ref`` and ``pallas-interpret``:

  * BFS (modes hybrid, dc, sc), CC and SSSP bit-exact: min folds are exact
    in any order;
  * PageRank within 1e-6, the reference's own tolerance
    (``tests/test_apps.py``): f32 adds are summed in another order;
  * the per-iteration Eq. 1 record (mode, DC and SC partition counts,
    active vertices and edges) equal, since both sides choose on the host
    from the same integer counts.
"""
import numpy as np
import pytest
import torch

import repro.apps as ref_apps
import repro_torch as rt
from repro.graph import build_layout, grid2d, rmat, star, symmetrize
from repro_torch.interop import layout_from_reference

torch.set_num_threads(1)

BACKENDS = ("ref", "pallas-interpret")
TILES = dict(k=8, edge_tile=64, msg_tile=32)


def _layouts(g):
    L = build_layout(g, **TILES)
    return g, L, layout_from_reference(L)


@pytest.fixture(scope="module")
def g_rmat():
    return _layouts(rmat(9, 8, seed=1))


@pytest.fixture(scope="module")
def g_weighted():
    return _layouts(rmat(9, 8, seed=2, weighted=True))


@pytest.fixture(scope="module")
def g_sym():
    return _layouts(symmetrize(rmat(9, 8, seed=1)))


def _assert_same_stats(port, ref):
    key = lambda s: (s.it, s.mode, s.dc_parts, s.sc_parts, s.n_active,
                     s.e_active, s.dc_bytes, s.sc_bytes)
    assert [key(s) for s in port] == [key(s) for s in ref]


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["hybrid", "dc", "sc"])
def test_bfs_matches_reference(g_rmat, mode, backend):
    g, L, TL = g_rmat
    src = int(np.argmax(g.out_degrees()))
    ref = ref_apps.bfs(L, source=src, mode=mode, backend=backend)
    port = rt.bfs(TL, source=src, mode=mode, device="cpu")
    _assert_same(port["parent"], ref["parent"])
    _assert_same(port["level"], ref["level"])
    _assert_same_stats(port["stats"], ref["stats"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["hybrid", "dc", "sc"])
def test_sssp_matches_reference(g_weighted, mode, backend):
    g, L, TL = g_weighted
    src = int(np.argmax(g.out_degrees()))
    ref = ref_apps.sssp(L, source=src, mode=mode, backend=backend)
    port = rt.sssp(TL, source=src, mode=mode, device="cpu")
    _assert_same(port["dist"], ref["dist"])
    _assert_same_stats(port["stats"], ref["stats"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_connected_components_matches_reference(g_sym, backend):
    g, L, TL = g_sym
    ref = ref_apps.connected_components(L, backend=backend)
    port = rt.connected_components(TL, device="cpu")
    _assert_same(port["label"], ref["label"])
    _assert_same_stats(port["stats"], ref["stats"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fused", [True, False])
def test_pagerank_matches_reference(g_rmat, fused, backend):
    g, L, TL = g_rmat
    ref = ref_apps.pagerank(L, iters=10, fused=fused, backend=backend)
    port = rt.pagerank(TL, iters=10, fused=fused, device="cpu")
    assert port["pr"].dtype == np.float32
    np.testing.assert_allclose(port["pr"], ref["pr"], rtol=0, atol=1e-6)
    _assert_same_stats(port["stats"], ref["stats"])


def test_bfs_plain_engine_matches_default(g_rmat):
    """``Engine(plain=True)`` (what the card-side check of chip_smoke.py
    runs) computes the same as the default engine."""
    g, _, TL = g_rmat
    src = int(np.argmax(g.out_degrees()))
    eng = rt.Engine(TL, rt.apps.bfs_program(), device="cpu", plain=True)
    plain = rt.bfs(TL, source=src, engine=eng)
    port = rt.bfs(TL, source=src, device="cpu")
    _assert_same(plain["parent"], port["parent"])
    _assert_same(plain["level"], port["level"])


@pytest.mark.parametrize("mode", ["hybrid", "dc", "sc"])
def test_bfs_from_a_sink_matches_reference(mode):
    """An active SC vertex with no out-edges (the reference's degree-0
    budget case, ``core/engine.py:437-438``): the port carries no stream."""
    L = build_layout(star(40), k=4, edge_tile=16, msg_tile=8)
    ref = ref_apps.bfs(L, source=7, mode=mode, backend="ref")
    port = rt.bfs(layout_from_reference(L), source=7, mode=mode,
                  device="cpu")
    _assert_same(port["parent"], ref["parent"])
    _assert_same(port["level"], ref["level"])
    _assert_same_stats(port["stats"], ref["stats"])


def test_bfs_large_diameter_matches_reference():
    L = build_layout(grid2d(17, 13), k=4, edge_tile=32, msg_tile=16)
    ref = ref_apps.bfs(L, source=0, backend="ref")
    port = rt.bfs(layout_from_reference(L), source=0, device="cpu")
    _assert_same(port["level"], ref["level"])
    _assert_same(port["parent"], ref["parent"])
    _assert_same_stats(port["stats"], ref["stats"])


# ---- the composed DC path (REPRO_FUSED=0): scatter into the bins, gather ----

@pytest.fixture
def composed(monkeypatch):
    """``REPRO_FUSED=0`` for both packages: engines built under it run the
    composed DC path.  Calling the fixture's value with ``True`` turns the
    fused path back on for the port's own fused run."""
    monkeypatch.setenv("REPRO_FUSED", "0")

    def fused(on: bool):
        monkeypatch.setenv("REPRO_FUSED", "1" if on else "0")
    return fused


def _port_engine(TL, program, mode="hybrid"):
    eng = rt.Engine(TL, program, mode=mode, device="cpu")
    assert not eng.fused
    return eng


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["hybrid", "dc", "sc"])
def test_composed_bfs_matches_reference(g_rmat, mode, backend, composed):
    g, L, TL = g_rmat
    src = int(np.argmax(g.out_degrees()))
    ref = ref_apps.bfs(L, source=src, mode=mode, backend=backend)
    port = rt.bfs(TL, source=src,
                  engine=_port_engine(TL, rt.apps.bfs_program(), mode))
    _assert_same(port["parent"], ref["parent"])
    _assert_same(port["level"], ref["level"])
    _assert_same_stats(port["stats"], ref["stats"])
    composed(True)
    fused = rt.bfs(TL, source=src, mode=mode, device="cpu")
    _assert_same(port["parent"], fused["parent"])
    _assert_same(port["level"], fused["level"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["hybrid", "dc"])
def test_composed_sssp_matches_reference(g_weighted, mode, backend, composed):
    g, L, TL = g_weighted
    src = int(np.argmax(g.out_degrees()))
    ref = ref_apps.sssp(L, source=src, mode=mode, backend=backend)
    port = rt.sssp(TL, source=src,
                   engine=_port_engine(TL, rt.apps.sssp_program(), mode))
    _assert_same(port["dist"], ref["dist"])
    _assert_same_stats(port["stats"], ref["stats"])
    composed(True)
    _assert_same(port["dist"],
                 rt.sssp(TL, source=src, mode=mode, device="cpu")["dist"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_composed_connected_components_matches_reference(g_sym, backend,
                                                         composed):
    g, L, TL = g_sym
    ref = ref_apps.connected_components(L, backend=backend)
    port = rt.connected_components(
        TL, engine=_port_engine(TL, rt.apps.cc_program()))
    _assert_same(port["label"], ref["label"])
    _assert_same_stats(port["stats"], ref["stats"])
    composed(True)
    _assert_same(port["label"],
                 rt.connected_components(TL, device="cpu")["label"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fused", [True, False])
def test_composed_pagerank_matches_reference(g_rmat, fused, backend,
                                             composed):
    g, L, TL = g_rmat
    ref = ref_apps.pagerank(L, iters=10, fused=fused, backend=backend)
    port = rt.pagerank(TL, iters=10, fused=fused, engine=_port_engine(
        TL, rt.apps.pagerank_program(TL.n), "dc"))
    assert port["pr"].dtype == np.float32
    np.testing.assert_allclose(port["pr"], ref["pr"], rtol=0, atol=1e-6)
    _assert_same_stats(port["stats"], ref["stats"])
    composed(True)
    np.testing.assert_allclose(
        port["pr"], rt.pagerank(TL, iters=10, fused=fused, device="cpu")["pr"],
        rtol=0, atol=1e-6)

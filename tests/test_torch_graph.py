"""The port's graph generators and layout against the reference's, array for
array (``repro_torch.graph`` is a NumPy copy of ``repro.graph``)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.graph as ref_graph
import repro_torch.graph as port_graph
from repro_torch.interop import layout_from_reference

torch.set_num_threads(1)

GRAPHS = {
    "rmat": lambda G: G.rmat(9, 8, seed=1),
    "rmat_weighted": lambda G: G.rmat(8, 8, seed=2, weighted=True),
    "uniform_random": lambda G: G.uniform_random(300, 2000, seed=3,
                                                 weighted=True),
    "ring": lambda G: G.ring(50),
    "star": lambda G: G.star(40),
    "grid2d": lambda G: G.grid2d(7, 5, weighted=True, seed=4),
}
TILES = dict(edge_tile=64, msg_tile=32, fold_tile=16, fold_q=24)


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_same_graph(g_port, g_ref):
    _assert_same_array(g_port.indptr, g_ref.indptr, "indptr")
    _assert_same_array(g_port.indices, g_ref.indices, "indices")
    assert (g_port.weights is None) == (g_ref.weights is None)
    if g_ref.weights is not None:
        _assert_same_array(g_port.weights, g_ref.weights, "weights")


def _assert_same_layout(l_port, l_ref):
    for f in dataclasses.fields(l_ref):
        a, b = getattr(l_port, f.name), getattr(l_ref, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            _assert_same_array(a, b, f.name)
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_match_reference(name):
    _assert_same_graph(GRAPHS[name](port_graph), GRAPHS[name](ref_graph))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_symmetrize_matches_reference(name):
    _assert_same_graph(port_graph.symmetrize(GRAPHS[name](port_graph)),
                       ref_graph.symmetrize(GRAPHS[name](ref_graph)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_layout_matches_reference(name):
    l_port = port_graph.build_layout(GRAPHS[name](port_graph), k=8, **TILES)
    l_ref = ref_graph.build_layout(GRAPHS[name](ref_graph), k=8, **TILES)
    _assert_same_layout(l_port, l_ref)


def test_build_layout_default_tiles_match_reference():
    """Unset tiles: the port's static defaults equal the reference's
    (its tuning cache is empty under the tests)."""
    l_port = port_graph.build_layout(GRAPHS["rmat"](port_graph))
    l_ref = ref_graph.build_layout(GRAPHS["rmat"](ref_graph))
    _assert_same_layout(l_port, l_ref)


def test_layout_from_reference_copies_every_field():
    l_ref = ref_graph.build_layout(GRAPHS["rmat_weighted"](ref_graph), k=8,
                                   **TILES)
    l_port = layout_from_reference(l_ref)
    assert isinstance(l_port, port_graph.Layout)
    _assert_same_layout(l_port, l_ref)
    assert l_port.edge_dst is not l_ref.edge_dst

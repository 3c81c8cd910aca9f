"""The port's sharded layout against the reference's, array for array
(``repro_torch.graph.shard`` is a NumPy copy of ``repro.graph.shard``)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.graph as ref_graph
import repro.graph.shard as ref_shard
import repro_torch.graph as port_graph
import repro_torch.graph.shard as port_shard

torch.set_num_threads(1)

TILES = dict(edge_tile=64, msg_tile=32, fold_tile=16, fold_q=24)
GRAPHS = {
    "rmat": lambda G: G.rmat(9, 8, seed=1),
    "rmat_weighted": lambda G: G.rmat(8, 8, seed=2, weighted=True),
    "grid2d_weighted": lambda G: G.grid2d(9, 7, weighted=True, seed=4),
}


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_shard_layout_matches_reference(name, D):
    kw = dict(k=8, **TILES)
    ref = ref_shard.shard_layout(
        ref_graph.build_layout(GRAPHS[name](ref_graph), **kw), D)
    port = port_shard.shard_layout(
        port_graph.build_layout(GRAPHS[name](port_graph), **kw), D)
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            _same(a, b, f.name)
        else:
            assert a == b, (f.name, a, b)
    assert (port.ne_d, port.ne_s) == (ref.ne_d, ref.ne_s)
    assert port.D * port.nv == port_graph.build_layout(
        GRAPHS[name](port_graph), **kw).n_pad
    pa, ra = port.arrays(), ref.arrays()
    assert list(pa) == list(ra)
    for key in ra:
        _same(pa[key], ra[key], key)


def test_shard_layout_refuses_an_uneven_split():
    L = port_graph.build_layout(port_graph.rmat(6, 4, seed=0), k=6,
                                edge_tile=16, msg_tile=8)
    with pytest.raises(ValueError, match="not divisible"):
        port_shard.shard_layout(L, 4)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_spec_matches_reference(D, weighted):
    kw = dict(n=5000, m=40000, D=D, k_per_dev=3, weighted=weighted)
    ref_arrs, ref_meta = ref_shard.sharded_spec(**kw)
    arrs, meta = port_shard.sharded_spec(**kw)
    assert meta == ref_meta
    assert list(arrs) == list(ref_arrs)
    for key, spec in ref_arrs.items():
        t = arrs[key]
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(spec.shape), key
        assert torch.empty(0, dtype=t.dtype).numpy().dtype == \
            np.dtype(spec.dtype), key

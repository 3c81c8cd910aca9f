"""The composed DC path's kernels against the reference's: ``dc_gather``,
``segment_combine``, ``spmv_block`` and their layout-bound classes.

On the CPU the port's wrappers run their plain PyTorch versions; the
references are the Pallas kernels in interpret mode and the pure-jnp oracles
(``repro.kernels.ref`` and the ``Ref*`` classes).  Both packages get the same
layout (``interop.layout_from_reference``): RMAT scale 9, ``k=8``,
``edge_tile=64``, ``msg_tile=32``, and a graph whose upper partitions receive
no edges.  Payloads and SpMV weights are integer-valued
(``tests/kernel_harness.py``), so every comparison is bit-exact, f32 add
included; they are finite, because the reference folds f32 add by a one-hot
matmul where one non-finite value spoils its whole partition.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # kernel_harness imports it
from kernel_harness import payload

import repro.graph as ref_graph
from repro.core import monoid as RM
from repro.kernels import ops as ref_ops
from repro.kernels import ref as kref
from repro.kernels.dc_gather import dc_gather as ref_dc_gather
from repro.kernels.segment_combine import segment_combine as ref_combine
from repro.kernels.spmv_block import spmv_block as ref_spmv
from repro_torch.interop import layout_from_reference, to_torch
from repro_torch.kernels import ops
from repro_torch.kernels.dc_gather import dc_gather
from repro_torch.kernels.segment_combine import segment_combine
from repro_torch.kernels.spmv_block import spmv_block

torch.set_num_threads(1)

MONOIDS = ("add", "min", "max")
DTYPES = ("float32", "int32", "uint32")
TILES = dict(k=8, edge_tile=64, msg_tile=32)


def _integer_weighted(g, seed):
    """``g`` with integer-valued f32 weights in [1, 8)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(g.n), g.out_degrees())
    w = rng.integers(1, 8, g.m).astype(np.float32)
    return ref_graph.from_edges(src, g.indices, n=g.n, weights=w)


@pytest.fixture(scope="module")
def layouts():
    g = _integer_weighted(ref_graph.rmat(9, 8, seed=1), 1)
    # every edge lands in the lower half: partitions 4..7 have no tiles
    h = ref_graph.rmat(9, 8, seed=5)
    src = np.repeat(np.arange(h.n), h.out_degrees())
    half = _integer_weighted(
        ref_graph.from_edges(src, h.indices % (h.n // 2), n=h.n, dedup=True),
        5)
    out = {}
    for name, graph in (("rmat", g), ("half", half)):
        L = ref_graph.build_layout(graph, **TILES)
        out[name] = (L, layout_from_reference(L))
    L, _ = out["half"]
    assert not L.part_has_tiles.all() and L.part_has_tiles.any()
    return out


def _t(a):
    return to_torch(np.asarray(a), device="cpu")


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monoid", MONOIDS)
def test_dc_gather_matches_reference(layouts, monoid, dtype, density):
    L, TL = layouts["rmat"]
    rng = np.random.default_rng(3)
    x = payload(rng, L.n_pad, dtype)
    active = jnp.asarray(rng.random(L.n_pad) < density)
    png_valid = jnp.asarray(L.png_src < L.n_pad)
    got = dc_gather(_t(x).view(L.k, L.q), _t(active).view(L.k, L.q),
                    _t(L.png_src_local), _t(png_valid), _t(L.png_tile_part),
                    k=L.k, q=L.q, msg_tile=L.msg_tile, monoid=monoid)
    _same(got, ref_dc_gather(x.reshape(L.k, L.q), active.reshape(L.k, L.q),
                             jnp.asarray(L.png_src_local), png_valid,
                             jnp.asarray(L.png_tile_part), k=L.k, q=L.q,
                             msg_tile=L.msg_tile, monoid=monoid,
                             interpret=True))
    _same(got, kref.dc_gather_ref(x, active, jnp.asarray(L.png_src),
                                  png_valid, monoid))


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monoid", MONOIDS)
def test_segment_combine_matches_reference(layouts, monoid, dtype, density):
    """Random ``part_active`` skips tiles; ``density`` 0 leaves every edge
    invalid; pad edges are in every layout."""
    L, TL = layouts["rmat"]
    rng = np.random.default_rng(4)
    vals = payload(rng, L.num_edges, dtype)
    valid = jnp.asarray(L.edge_valid & (rng.random(L.num_edges) < density))
    part_active = jnp.asarray(rng.random(L.k) < 0.5)
    acc, touched = segment_combine(
        _t(vals), _t(valid), _t(L.edge_dst_local), _t(L.tile_dst_part),
        _t(L.tile_src_part), _t(L.tile_first), _t(part_active), k=L.k,
        q=L.q, edge_tile=L.edge_tile, monoid=monoid)
    assert touched.dtype == torch.bool
    want_acc, want_touched = ref_combine(
        vals, valid, jnp.asarray(L.edge_dst_local),
        jnp.asarray(L.tile_dst_part), jnp.asarray(L.tile_src_part),
        jnp.asarray(L.tile_first), part_active, k=L.k, q=L.q,
        edge_tile=L.edge_tile, monoid=monoid, interpret=True)
    assert L.part_has_tiles.all()
    _same(acc, want_acc)
    _same(touched, np.asarray(want_touched) > 0)
    # the oracle with the 2-level skip folded into the validity
    live = valid & part_active[np.repeat(L.tile_src_part, L.edge_tile)]
    oracle = kref.segment_combine_ref(vals, live, jnp.asarray(L.edge_dst),
                                      L.n_pad + 1, monoid)
    _same(acc.reshape(-1), oracle[0][:L.n_pad])
    _same(touched.reshape(-1), oracle[1][:L.n_pad])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_spmv_block_matches_reference(layouts, density, weighted):
    L, TL = layouts["rmat"]
    rng = np.random.default_rng(5)
    x = payload(rng, L.n_pad, "float32")
    valid = jnp.asarray(L.edge_valid & (rng.random(L.num_edges) < density))
    w = jnp.asarray(L.edge_w) if weighted else None
    got = spmv_block(_t(x).view(L.k, L.q), _t(L.edge_src_local),
                     _t(L.edge_dst_local), _t(valid),
                     _t(w) if weighted else None, _t(L.tile_dst_part),
                     _t(L.tile_src_part), _t(L.tile_first), k=L.k, q=L.q,
                     edge_tile=L.edge_tile, weighted=weighted)
    _same(got, ref_spmv(x.reshape(L.k, L.q), jnp.asarray(L.edge_src_local),
                        jnp.asarray(L.edge_dst_local), valid, w,
                        jnp.asarray(L.tile_dst_part),
                        jnp.asarray(L.tile_src_part),
                        jnp.asarray(L.tile_first), k=L.k, q=L.q,
                        edge_tile=L.edge_tile, weighted=weighted,
                        interpret=True))
    _same(got.reshape(-1), kref.spmv_block_ref(
        x, jnp.asarray(L.msg_slot), jnp.asarray(L.png_src),
        jnp.asarray(L.edge_dst), valid, w, L.n_pad))


@pytest.mark.parametrize("layout", ["rmat", "half"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monoid", MONOIDS)
def test_gather_and_scatter_kernels_match_reference(layouts, monoid, dtype,
                                                    layout):
    """The layout-bound classes, partitions with no tiles included: those
    get the identity and stay untouched in both packages."""
    L, TL = layouts[layout]
    mono = RM.REGISTRY[monoid](jnp.dtype(dtype))
    rng = np.random.default_rng(6)
    x = payload(rng, L.n_pad, dtype)
    active = jnp.asarray(rng.random(L.n_pad) < 0.5)
    sk = ops.ScatterKernel(TL, monoid, getattr(torch, dtype), "cpu")
    got = sk(_t(x), _t(active))
    _same(got, ref_ops.ScatterKernel(L, monoid, dtype, interpret=True)(
        x, active))
    _same(got, ref_ops.RefScatter(L, mono)(x, active))

    vals = payload(rng, L.num_edges, dtype)
    valid = jnp.asarray(L.edge_valid & (rng.random(L.num_edges) < 0.7))
    part_active = jnp.asarray((rng.random(L.k) < 0.6).astype(np.int32))
    gk = ops.GatherKernel(TL, monoid, getattr(torch, dtype), "cpu")
    acc, touched = gk(_t(vals), _t(valid), _t(part_active))
    for want in (ref_ops.GatherKernel(L, monoid, dtype, interpret=True)(
                     vals, valid, part_active),
                 ref_ops.RefGather(L, mono)(vals, valid, part_active)):
        _same(acc, want[0])
        _same(touched, want[1])
    empty = ~np.repeat(L.part_has_tiles, L.q)
    assert not touched.numpy()[empty].any()
    ident = np.full(int(empty.sum()), np.asarray(mono.identity), dtype)
    assert np.array_equal(acc.numpy()[empty].view(np.uint8),
                          ident.view(np.uint8))


@pytest.mark.parametrize("layout", ["rmat", "half"])
@pytest.mark.parametrize("weighted", [None, False, True])
def test_spmv_kernel_matches_reference(layouts, weighted, layout):
    """``weighted=None`` takes the layout's own (weighted here); partitions
    with no tiles are 0."""
    L, TL = layouts[layout]
    x = payload(np.random.default_rng(7), L.n_pad, "float32")
    kern = ops.SpmvKernel(TL, "cpu", weighted=weighted)
    assert kern.weighted == (L.weighted if weighted is None else weighted)
    got = kern(_t(x))
    _same(got, ref_ops.SpmvKernel(L, interpret=True, weighted=weighted)(x))
    _same(got, ref_ops.RefSpmv(L, weighted=weighted)(x))
    assert not got.numpy()[~np.repeat(L.part_has_tiles, L.q)].any()


def test_partition_tile_offsets_checks_the_layout(layouts):
    L, TL = layouts["half"]
    off = ops._partition_tile_offsets(TL)
    assert off[0] == 0 and off[-1] == TL.num_edge_tiles
    assert np.array_equal(off[1:] > off[:-1], TL.part_has_tiles)
    bad = layout_from_reference(L)
    bad.tile_first = np.roll(bad.tile_first, 1)
    with pytest.raises(ValueError, match="tile_first"):
        ops.GatherKernel(bad, "min", torch.float32, "cpu")
    bad = layout_from_reference(L)
    bad.tile_dst_part = bad.tile_dst_part[::-1].copy()
    with pytest.raises(ValueError, match="destination-major"):
        ops.SpmvKernel(bad, "cpu")


def test_wrappers_raise_on_unsupported_device():
    def meta(n, dtype=torch.int32):
        return torch.zeros(n, dtype=dtype, device="meta")

    x = torch.zeros((2, 4), device="meta")
    act = torch.zeros((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        dc_gather(x, act, meta(8), meta(8, torch.bool), meta(2), k=2, q=4,
                  msg_tile=4, monoid="min")
    with pytest.raises(ValueError, match="device"):
        segment_combine(meta(8, torch.float32), meta(8, torch.bool), meta(8),
                        meta(2), meta(2), meta(2, torch.bool),
                        meta(2, torch.bool), k=2, q=4, edge_tile=4,
                        monoid="min")
    with pytest.raises(ValueError, match="device"):
        spmv_block(x, meta(8), meta(8), meta(8, torch.bool), None, meta(2),
                   meta(2), meta(2, torch.bool), k=2, q=4, edge_tile=4)

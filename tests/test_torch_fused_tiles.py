"""The port's fused DC step in the layout's tile form against the reference.

``repro_torch.kernels.ops.FusedDCKernel`` binds a layout's tile arrays (the
CUDA kernel reads those in place of the global ``idx`` and ``dst``) and, on
the CPU, builds ``idx`` and ``dst`` from them with torch ops.  Here it is held
against the reference's ``FusedDCKernel`` (the Pallas kernel in interpret
mode) and its pure-jnp ``RefFusedDC`` on the same layout
(``interop.layout_from_reference``): RMAT scale 8, ``k=4``, at edge tiles 16,
24 (not a multiple of 16: the CUDA kernel's plain-load path) and 128.
Payloads and weights are integer-valued, so every comparison is bit-exact,
f32 add included.  The kernel itself is held against the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as ref_graph
from repro.core import monoid as RM
from repro.kernels import ops as ref_ops
from repro_torch.interop import layout_from_reference, to_torch
from repro_torch.kernels import fused_step, ops
from repro_torch.kernels._build import CSRC
from repro_torch.kernels.fused_step import (EdgeTiles, add_weight,
                                            fused_dc_cuda, fused_scatter_fold)

torch.set_num_threads(1)

MONOIDS = ("add", "min", "max")
DTYPES = ("float32", "int32", "uint32")
EDGE_TILES = (16, 24, 128)


def _relax(v, w):
    """The reference side of ``add_weight``."""
    return v + w


@pytest.fixture(scope="module")
def layouts():
    """{edge_tile: (reference layout, port layout)} of one weighted graph
    with integer-valued weights in [1, 8)."""
    g = ref_graph.rmat(8, 8, seed=3)
    rng = np.random.default_rng(3)
    src = np.repeat(np.arange(g.n), g.out_degrees())
    g = ref_graph.from_edges(src, g.indices, n=g.n,
                             weights=rng.integers(1, 8, g.m).astype(
                                 np.float32))
    out = {}
    for et in EDGE_TILES:
        L = ref_graph.build_layout(g, k=4, edge_tile=et,
                                   msg_tile=max(8, et // 2))
        out[et] = (L, layout_from_reference(L))
    return out


def _payload(rng, n, dtype):
    lo = 0 if dtype == "uint32" else -64
    return rng.integers(lo, 64, n).astype(dtype)


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _table(L, dtype, seed):
    """A message table of n_pad + 1 slots, about half of them valid."""
    rng = np.random.default_rng(seed)
    table = _payload(rng, L.n_pad + 1, dtype)
    valid = rng.random(L.n_pad + 1) < 0.5
    return table, valid


@pytest.mark.parametrize("edge_tile", EDGE_TILES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monoid", MONOIDS)
def test_fused_kernel_matches_reference(layouts, monoid, dtype, edge_tile):
    L, TL = layouts[edge_tile]
    table, valid = _table(L, dtype, seed=edge_tile)
    got = ops.FusedDCKernel(TL, monoid, getattr(torch, dtype), "cpu")(
        to_torch(table, device="cpu"), to_torch(valid, device="cpu"))
    for want in (
            ref_ops.FusedDCKernel(L, monoid, jnp.dtype(dtype),
                                  interpret=True)(table, valid),
            ref_ops.RefFusedDC(L, RM.REGISTRY[monoid](jnp.dtype(dtype)))(
                table, valid)):
        _same(got[0], want[0])
        _same(got[1], want[1])


@pytest.mark.parametrize("edge_tile", EDGE_TILES)
def test_fused_add_weight_matches_reference(layouts, edge_tile):
    """SSSP's edge function on the weighted layout (f32 min)."""
    L, TL = layouts[edge_tile]
    table, valid = _table(L, "float32", seed=100 + edge_tile)
    kern = ops.FusedDCKernel(TL, "min", torch.float32, "cpu",
                             apply_weight=add_weight)
    assert kern.edge_w is not None
    got = kern(to_torch(table, device="cpu"), to_torch(valid, device="cpu"))
    ref = ref_ops.FusedDCKernel(L, "min", jnp.float32, interpret=True)
    oracle = ref_ops.RefFusedDC(L, RM.min_(jnp.float32))
    ref.apply_weight = oracle.apply_weight = _relax
    for want in (ref(table, valid), oracle(table, valid)):
        _same(got[0], want[0])
        _same(got[1], want[1])


@pytest.mark.parametrize("edge_tile", EDGE_TILES)
def test_torch_built_edges_equal_the_reference_arrays(layouts, edge_tile):
    """The plain route's ``idx`` and ``dst``, built from the tiles with
    torch ops, are the reference's ``_edge_src_global(layout)`` and
    ``layout.edge_dst``, pads included; without an edge function the
    weights stay on the host."""
    L, TL = layouts[edge_tile]
    kern = ops.FusedDCKernel(TL, "add", torch.float32, "cpu")
    assert kern.edge_w is None
    for got, want in ((kern.edge_src, ref_ops._edge_src_global(L)),
                      (kern.edge_dst, L.edge_dst)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert kern.tiles.edge_tile == edge_tile and kern.tiles.q == L.q


@pytest.mark.parametrize("breach", ["edge_dst", "dst_local_high",
                                    "dst_local_negative"])
def test_fused_path_raises_on_an_edge_outside_its_partition(layouts, breach):
    """A valid edge whose ``edge_dst`` is not its tile's partition base plus
    its ``edge_dst_local`` in ``[0, q)``: the fused kernel's per-edge
    precondition, checked on the device when a layout is bound."""
    L, _ = layouts[16]
    bad = layout_from_reference(L)
    e = int(np.flatnonzero(bad.edge_valid)[7])
    if breach == "edge_dst":
        bad.edge_dst = bad.edge_dst.copy()
        bad.edge_dst[e] = (bad.edge_dst[e] + bad.q) % bad.n_pad
    else:
        bad.edge_dst_local = bad.edge_dst_local.copy()
        bad.edge_dst_local[e] = bad.q if breach == "dst_local_high" else -1
        bad.edge_dst = bad.edge_dst.copy()
        t = e // bad.edge_tile
        bad.edge_dst[e] = bad.tile_dst_part[t] * bad.q + bad.edge_dst_local[e]
    with pytest.raises(ValueError, match="outside its destination partition"):
        ops.FusedDCKernel(bad, "min", torch.float32, "cpu")
    # the same breach on an invalid edge is no breach
    bad.edge_valid = bad.edge_valid.copy()
    bad.edge_valid[e] = False
    ops.FusedDCKernel(bad, "min", torch.float32, "cpu")


def test_fused_path_checks_the_tile_structure(layouts):
    L, _ = layouts[16]
    bad = layout_from_reference(L)
    bad.tile_first = np.roll(bad.tile_first, 1)
    with pytest.raises(ValueError, match="tile_first"):
        ops.FusedDCKernel(bad, "add", torch.float32, "cpu")


def test_fused_dc_cuda_refuses_cpu_tensors(layouts):
    """The CUDA wrapper checks its inputs before any build or launch; and
    ``fused_scatter_fold`` on the CPU stays the reference's contract."""
    L, TL = layouts[16]
    kern = ops.FusedDCKernel(TL, "add", torch.float32, "cpu")
    table = torch.zeros(L.n_pad + 1)
    valid = torch.ones(L.n_pad + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fused_dc_cuda(table, valid, kern.edge_valid, L.n_pad + 1, "add",
                      kern.tiles)
    assert isinstance(kern.tiles, EdgeTiles)
    acc, touched = fused_scatter_fold(table, valid, kern.edge_src,
                                      kern.edge_valid, kern.edge_dst,
                                      L.n_pad + 1, monoid="add")
    want = ref_ops.RefFusedDC(L, RM.add(jnp.float32))(
        np.zeros(L.n_pad + 1, np.float32), np.ones(L.n_pad + 1, bool))
    _same(acc, want[0])
    _same(touched, want[1])


@pytest.mark.parametrize("source", ["fused_dc.cu", "segment_combine.cu"])
def test_python_mirrors_of_the_tile_kernels_constants(source):
    """``fused_step.max_chunk`` (shared by the segment_combine wrapper) is
    each tile kernel's ``kMaxChunk<T>``, in its source or a header of
    ``csrc/`` it includes: ``MAX_CHUNK`` for 4-byte accumulators,
    ``WIDE_MAX_CHUNK`` for 8-byte ones."""
    text = (CSRC / source).read_text()
    text += "".join((CSRC / h).read_text()
                    for h in re.findall(r'#include "(\w+\.cuh)"', text))
    found = re.search(r"constexpr [a-z ]+kMaxChunk = sizeof\(T\) == 8 \? "
                      r"(\d+) : (\d+);", text)
    assert found
    wide, narrow = int(found.group(1)), int(found.group(2))
    assert (narrow, wide) == (fused_step.MAX_CHUNK, fused_step.WIDE_MAX_CHUNK)
    assert fused_step.max_chunk(torch.float32) == narrow
    assert fused_step.max_chunk(torch.int64) == wide

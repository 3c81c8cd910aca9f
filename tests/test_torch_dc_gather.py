"""The host side of the port's DC scatter: the staged regime's pieces, the
layout-bound ``ScatterKernel`` against the reference, and the C bindings.

``csrc/dc_gather.cu`` stages one source partition's rows per block over a
piece of the slot tiles (:func:`repro_torch.kernels.dc_gather.dc_pieces`,
built on the host when ``ScatterKernel`` binds a layout on a card).  The
kernel runs only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
here the pieces are held to their contract on the tests' small-k layouts,
and ``ScatterKernel`` on the CPU (the plain version) against the reference's
Pallas kernel in interpret mode at the tuner's four tile geometries.
Payloads are integer-valued, so every comparison is bit-exact.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # kernel_harness imports it
from kernel_harness import payload

import repro.graph as ref_graph
from repro.kernels.dc_gather import dc_gather as ref_dc_gather
from repro_torch.interop import layout_from_reference, to_torch
from repro_torch.kernels import _build
from repro_torch.kernels.dc_gather import dc_gather, dc_pieces
from repro_torch.kernels.ops import ScatterKernel

torch.set_num_threads(1)

SMS = 132   # the H100's SMs: the pieces a card of it asks for
# (k, edge_tile, msg_tile): the CPU and card tests' small-k layouts
SMALL_K = {"k8_mt32": (8, 64, 32), "k8_mt64": (8, 128, 64),
           "k8_mt512": (8, 1024, 512), "k2_mt32": (2, 64, 32),
           "k4_mt30": (4, 64, 30)}
# the tuner's four card geometries (edge_tile, msg_tile = edge_tile / 2)
TUNER = ((128, 64), (256, 128), (512, 256), (1024, 512))


@pytest.fixture(scope="module")
def graph():
    return ref_graph.rmat(11, 8, seed=3)


@pytest.fixture(scope="module")
def small_k(graph):
    return {name: ref_graph.build_layout(graph, k=k, edge_tile=et,
                                         msg_tile=mt)
            for name, (k, et, mt) in SMALL_K.items()}


def _check_pieces(off, tile_part):
    """``off`` covers every tile exactly once and each piece lies in one
    source partition."""
    ntm = len(tile_part)
    assert off.dtype == np.int64 and off[0] == 0 and off[-1] == ntm
    assert np.all(np.diff(off) > 0)
    piece = np.repeat(np.arange(len(off) - 1), np.diff(off))
    assert np.array_equal(tile_part, tile_part[off[:-1]][piece])


@pytest.mark.parametrize("blocks", [SMS, 7])
@pytest.mark.parametrize("name", sorted(SMALL_K))
def test_pieces_cover_each_tile_once_within_one_partition(small_k, name,
                                                          blocks):
    L = small_k[name]
    tp = np.asarray(L.png_tile_part)
    off = dc_pieces(tp, q=L.q, msg_tile=L.msg_tile, blocks=blocks)
    assert off is not None, "a layout's tiles are in source-partition runs"
    _check_pieces(off, tp)
    runs = 1 + int(np.count_nonzero(tp[1:] != tp[:-1]))
    assert len(off) - 1 == max(runs, min(blocks, len(tp)))
    assert len(off) - 1 >= min(blocks, len(tp))


def test_pieces_cut_the_largest_runs_first():
    """128 source partitions on 132 SMs, as at RMAT scale 22: the four
    largest runs are halved and the rest stay whole; within a run the pieces
    differ by at most a tile."""
    rng = np.random.default_rng(0)
    runs = rng.permutation(np.arange(1650, 1778))
    tp = np.repeat(np.arange(128), runs).astype(np.int32)
    off = dc_pieces(tp, q=32768, msg_tile=128, blocks=SMS)
    _check_pieces(off, tp)
    sizes = np.diff(off)
    assert len(sizes) == SMS
    split = np.bincount(tp[off[:-1]], minlength=128)
    assert set(np.flatnonzero(split == 2)) == set(np.argsort(runs)[-4:])
    assert sizes.max() == np.sort(runs)[-5]
    for r in np.flatnonzero(split == 2):
        halves = sizes[tp[off[:-1]] == r]
        assert halves.sum() == runs[r] and np.ptp(halves) <= 1


@pytest.mark.parametrize("blocks", [1, SMS, 10_000])
def test_pieces_never_cut_below_one_tile(blocks):
    tp = np.repeat(np.arange(3), [5, 1, 40]).astype(np.int32)
    off = dc_pieces(tp, q=16, msg_tile=32, blocks=blocks)
    _check_pieces(off, tp)
    assert len(off) - 1 == max(3, min(blocks, len(tp)))


@pytest.mark.parametrize("name", sorted(SMALL_K))
def test_shuffled_tiles_give_per_run_pieces_or_l2(small_k, name):
    """Tiles shuffled out of source-partition order leave short runs.  Where
    the mean run's slot stream is under the row a block would stage, no
    pieces (the kernel reads every source through L2); else (a 512-slot tile
    against a 256-vertex row) pieces that each lie in one run."""
    L = small_k[name]
    tp = np.random.default_rng(1).permutation(np.asarray(L.png_tile_part))
    off = dc_pieces(tp, q=L.q, msg_tile=L.msg_tile, blocks=SMS)
    runs = 1 + int(np.count_nonzero(tp[1:] != tp[:-1]))
    short = len(tp) * L.msg_tile * 9 < runs * L.q * 5
    assert (off is None) == short
    assert short == (name != "k8_mt512")
    if off is not None:
        _check_pieces(off, tp)


@pytest.mark.parametrize("slots_per_vertex, staged",
                         [(5 / 9 - 0.01, False), (5 / 9, True)])
def test_staging_needs_a_run_stream_of_at_least_its_row(slots_per_vertex,
                                                        staged):
    """The boundary of :func:`dc_pieces`' choice: a mean run of 9-byte slots
    against a 5-byte-a-vertex row of ``q`` vertices."""
    q, msg_tile, k = 900, 10, 4
    tiles = int(round(slots_per_vertex * q / msg_tile))
    tp = np.repeat(np.arange(k), tiles).astype(np.int32)
    off = dc_pieces(tp, q=q, msg_tile=msg_tile, blocks=SMS)
    assert (off is not None) == staged
    assert dc_pieces(np.zeros(0, np.int32), q=q, msg_tile=msg_tile,
                     blocks=SMS) is None


@pytest.fixture(scope="module")
def tuner_layouts(graph):
    out = {}
    for et, mt in TUNER:
        L = ref_graph.build_layout(graph, k=8, edge_tile=et, msg_tile=mt)
        out[et, mt] = (L, layout_from_reference(L))
    return out


def _t(a):
    return to_torch(np.asarray(a), device="cpu")


@pytest.mark.parametrize("monoid", ["add", "min", "max"])
@pytest.mark.parametrize("geometry", TUNER, ids=lambda g: f"et{g[0]}")
def test_scatter_kernel_matches_reference_at_tuner_geometries(
        tuner_layouts, geometry, monoid):
    """``ScatterKernel`` as the composed engine binds it, on the CPU, against
    the reference's ``dc_gather`` (Pallas, interpret mode); half the
    sources active.  The CPU binding builds no pieces."""
    L, TL = tuner_layouts[geometry]
    rng = np.random.default_rng(geometry[0])
    x = payload(rng, L.n_pad, "int32")
    active = rng.random(L.n_pad) < 0.5
    sk = ScatterKernel(TL, monoid, torch.int32, "cpu")
    assert sk.pieces is None
    got = sk(_t(x), torch.from_numpy(active))
    png_valid = jnp.asarray(L.png_src < L.n_pad)
    want = ref_dc_gather(x.reshape(L.k, L.q), jnp.asarray(active).reshape(
        L.k, L.q), jnp.asarray(L.png_src_local), png_valid,
        jnp.asarray(L.png_tile_part), k=L.k, q=L.q, msg_tile=L.msg_tile,
        monoid=monoid, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_version_needs_no_pieces(small_k):
    """On CPU tensors ``dc_gather`` runs the plain version and gives the same
    bins with or without pieces."""
    L = small_k["k8_mt32"]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(np.asarray(payload(rng, L.n_pad, "float32"))).view(
        L.k, L.q)
    active = torch.from_numpy(rng.random(L.n_pad) < 0.5).view(L.k, L.q)
    args = (x, active, torch.from_numpy(L.png_src_local),
            torch.from_numpy(L.png_src < L.n_pad),
            torch.from_numpy(L.png_tile_part))
    geo = dict(k=L.k, q=L.q, msg_tile=L.msg_tile, monoid="min")
    pieces = torch.from_numpy(dc_pieces(L.png_tile_part, q=L.q,
                                        msg_tile=L.msg_tile, blocks=SMS))
    assert torch.equal(dc_gather(*args, **geo),
                       dc_gather(*args, **geo, pieces=pieces))


@pytest.mark.parametrize("kernel", _build.KERNELS, ids=lambda k: k.name)
def test_c_entries_take_what_their_bindings_pass(kernel):
    """Each C entry declares as many parameters as ``_build`` binds
    (``ctypes`` does not check a call against the library)."""
    text = kernel.source.read_text()
    found = re.search(rf'extern "C" int {kernel.name}\(([^)]*)\)', text)
    assert found, f"{kernel.source.name} declares no {kernel.name}"
    assert len(found.group(1).split(",")) == len(kernel.argtypes)


def test_regime_counts_reset_with_the_launch_counts():
    kern = _build.DC_GATHER
    assert tuple(kern.regimes) == ("l2", "staged")
    kern.count_regime(1)
    assert kern.regimes["staged"] >= 1
    _build.reset_launch_counts()
    assert kern.regimes == {"l2": 0, "staged": 0} and kern.launches == 0

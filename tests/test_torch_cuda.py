"""The CUDA kernels on a card against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc, and skips without them.  This file imports
neither JAX nor the reference package, so it runs where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Payloads are integer-valued, so every kernel result is bit-exact, f32 add
included, whatever order the atomics fold in.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core import monoid as M
from repro_torch.graph import build_layout, from_edges, rmat, symmetrize
from repro_torch.kernels import _build
from repro_torch.kernels.dc_gather import (dc_gather_cuda, dc_pieces,
                                           ref_dc_gather)
from repro_torch.kernels.fold_block import segment_fold, segment_fold_cuda
from repro_torch.kernels.fused_step import (MAX_CHUNK, EdgeTiles,
                                            PartRanges, add_weight,
                                            add_weight_to_key,
                                            build_lane_edges, fused_dc_cuda,
                                            fused_scatter_fold, global_edges,
                                            lane_group, lane_width,
                                            ref_fused_scatter_fold,
                                            ref_interleave_lanes)
from repro_torch.kernels.ops import (FusedDCKernel, FusedStreamKernel,
                                     GatherKernel, ScatterKernel, SpmvKernel)
from repro_torch.kernels.segment_combine import (ref_segment_combine,
                                                 segment_combine_cuda)
from repro_torch.kernels.spmv_block import ref_spmv_block, spmv_block_cuda

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

MONOIDS = ("add", "min", "max")
DTYPES = {"float32": torch.float32, "int32": torch.int32,
          "uint32": torch.uint32}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_all()
    return torch.device("cuda")


def _payload(rng, n, dtype, device):
    lo = 0 if dtype == torch.uint32 else -64
    a = rng.integers(lo, 64, n)
    if dtype == torch.uint32:
        return torch.from_numpy(a.astype(np.int32)).to(device).view(
            torch.uint32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _assert_bit_exact(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g8 = g.contiguous().view(torch.uint8) if g.dtype != torch.bool else g
        w8 = w.contiguous().view(torch.uint8) if w.dtype != torch.bool else w
        assert torch.equal(g8, w8)


# both regimes of the CUDA fold (shared memory up to 40,960 segments, its
# kSharedMaxSegments, global atomics past it), the boundary on both sides,
# and a tiny count
@pytest.mark.parametrize("ns", [7, 4096, 40959, 40960, 40961, 300_001])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("monoid", MONOIDS)
def test_segment_fold_kernel_matches_plain(dev, monoid, dtype, ns):
    rng = np.random.default_rng(1)
    n = 200_000
    vals = _payload(rng, n, DTYPES[dtype], dev)
    valid = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    ids = torch.from_numpy(
        rng.integers(-8, ns + 8, n).astype(np.int32)).to(dev)
    before = _build.SEGMENT_FOLD.launches
    got = segment_fold_cuda(vals, valid, ids, ns, monoid)
    torch.cuda.synchronize()
    assert _build.SEGMENT_FOLD.launches == before + 1
    _assert_bit_exact(got, segment_fold(vals, valid, ids, ns, monoid))


def _fold_stream(rng, case, n, ns, dtype, device):
    """(vals, valid, ids) for one of the edge cases of the fold's stream."""
    vals = _payload(rng, n, dtype, device)
    valid = rng.random(n) < 0.8
    ids = rng.integers(0, ns, n)
    if case == "all_invalid":
        valid[:] = False
    elif case == "out_of_range":
        ids = np.where(rng.random(n) < 0.5, rng.integers(-2**31, 0, n),
                       rng.integers(ns, 2**31, n))
    elif case == "sorted_runs":   # long runs of equal ids, as the tuner's
        ids = np.sort(rng.integers(0, max(1, ns // 64), n))
    return (vals, torch.from_numpy(valid).to(device),
            torch.from_numpy(ids.astype(np.int32)).to(device))


@pytest.mark.parametrize("case", ["empty", "all_invalid", "out_of_range",
                                  "sorted_runs"])
@pytest.mark.parametrize("ns", [4096, 300_001])
@pytest.mark.parametrize("monoid", MONOIDS)
def test_segment_fold_kernel_edge_streams(dev, monoid, ns, case):
    """No messages, no valid message, no id in range, and a sorted stream
    whose runs span many warps; in both regimes."""
    rng = np.random.default_rng(8)
    n = 0 if case == "empty" else 150_000
    for dtype in DTYPES.values():
        stream = _fold_stream(rng, case, n, ns, dtype, dev)
        got = segment_fold_cuda(*stream, ns, monoid)
        torch.cuda.synchronize()
        _assert_bit_exact(got, segment_fold(*stream, ns, monoid))


@pytest.fixture(scope="module")
def layouts():
    g = rmat(11, 8, seed=3, weighted=True)
    wide = rmat(17, 2, seed=4)
    src = np.repeat(np.arange(g.n), g.out_degrees())
    # every edge lands in the lower half: partitions 4..7 have no tiles
    half = from_edges(src, g.indices % (g.n // 2), n=g.n, dedup=True)
    return {"rmat": build_layout(g, k=8, edge_tile=64, msg_tile=32),
            # q = 65536 > MAX_CHUNK: each partition spans two blocks
            "wide": build_layout(wide, k=2, edge_tile=64, msg_tile=32),
            "half": build_layout(half, k=8, edge_tile=64, msg_tile=32),
            # the tuner's smallest and largest edge tiles
            "et128": build_layout(g, k=8, edge_tile=128, msg_tile=64),
            "et1024": build_layout(g, k=8, edge_tile=1024, msg_tile=512),
            "sparse": build_layout(_sparse_graph(), k=8, edge_tile=64,
                                   msg_tile=32),
            # not a multiple of 16: the SpMV's plain-load path
            "et24": build_layout(g, k=8, edge_tile=24, msg_tile=32)}


def _sparse_graph():
    """2048 vertices in 8 partitions of 256: partition 0 receives no edge,
    partition 1 one tile's worth (at edge_tile 64), partition 2 37 tiles
    from one source partition (more than two ring stages of 16 such tiles,
    and not a multiple of 16), the rest a random sprinkle."""
    rng = np.random.default_rng(9)
    pairs = rng.choice(256 * 256, 36 * 64 + 5, replace=False)
    src = np.concatenate([np.arange(10), 768 + pairs // 256,
                          rng.integers(0, 2048, 3000)])
    dst = np.concatenate([256 + np.arange(10), 512 + pairs % 256,
                          rng.integers(768, 2048, 3000)])
    return from_edges(src, dst, n=2048, dedup=True)


def test_sparse_layout_has_the_intended_partitions(dev, layouts):
    L = layouts["sparse"]
    tiles = np.bincount(L.tile_dst_part, minlength=L.k)
    assert (L.q, tiles[0], tiles[1], tiles[2]) == (256, 0, 1, 37)


@pytest.mark.parametrize("layout", ["rmat", "wide"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("monoid", MONOIDS)
def test_fused_dc_kernel_matches_plain(dev, layouts, monoid, dtype, layout):
    L = layouts[layout]
    assert layout != "wide" or L.q > MAX_CHUNK
    rng = np.random.default_rng(2)
    m = L.n_pad + 1
    table = _payload(rng, m, DTYPES[dtype], dev)
    table_valid = torch.from_numpy(rng.random(m) < 0.5).to(dev)
    kern = FusedDCKernel(L, monoid, DTYPES[dtype], dev)
    plain = FusedDCKernel(L, monoid, DTYPES[dtype], dev, plain=True)
    before = _build.FUSED_DC.launches
    got = kern(table, table_valid)
    torch.cuda.synchronize()
    assert _build.FUSED_DC.launches == before + 1
    _assert_bit_exact(got, plain(table, table_valid))


def test_fused_dc_add_weight_matches_plain(dev, layouts):
    L = layouts["rmat"]
    rng = np.random.default_rng(3)
    m = L.n_pad + 1
    table = _payload(rng, m, torch.float32, dev)
    table_valid = torch.from_numpy(rng.random(m) < 0.5).to(dev)
    kern = FusedDCKernel(L, "min", torch.float32, dev)
    plain = FusedDCKernel(L, "min", torch.float32, dev, plain=True)
    kern.edge_w = plain.edge_w = _payload(rng, L.num_edges, torch.float32,
                                          dev)
    kern.apply_weight = plain.apply_weight = add_weight
    _assert_bit_exact(kern(table, table_valid), plain(table, table_valid))
    kern.apply_weight = lambda v, w: v * w
    with pytest.raises(ValueError, match="edge function"):
        kern(table, table_valid)


def test_wrappers_check_their_inputs(dev):
    vals = torch.zeros(8, device=dev)
    valid = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        segment_fold_cuda(vals, valid, torch.zeros(8, dtype=torch.int64,
                                                   device=dev), 4, "min")
    with pytest.raises(ValueError):
        segment_fold_cuda(vals, valid, torch.zeros(8, dtype=torch.int32), 4,
                          "min")


def test_apps_on_the_card_match_the_cpu(dev):
    g = rmat(10, 8, seed=5, weighted=True)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    S = build_layout(symmetrize(g), k=8, edge_tile=64, msg_tile=32)
    src = int(np.argmax(g.out_degrees()))
    for mode in ("hybrid", "dc", "sc"):
        a, b = rt.bfs(L, src, mode=mode), rt.bfs(L, src, mode=mode,
                                                 device="cpu")
        assert np.array_equal(a["level"], b["level"])
        assert np.array_equal(a["parent"], b["parent"])
        a, b = rt.sssp(L, src, mode=mode), rt.sssp(L, src, mode=mode,
                                                   device="cpu")
        assert np.array_equal(a["dist"], b["dist"])
    assert np.array_equal(rt.connected_components(S)["label"],
                          rt.connected_components(S, device="cpu")["label"])
    for fused in (True, False):
        np.testing.assert_allclose(
            rt.pagerank(L, fused=fused)["pr"],
            rt.pagerank(L, fused=fused, device="cpu")["pr"], rtol=0,
            atol=1e-6)


@pytest.mark.parametrize("layout", ["rmat", "wide"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("monoid", MONOIDS)
def test_dc_gather_kernel_matches_plain(dev, layouts, monoid, dtype, layout):
    L = layouts[layout]
    rng = np.random.default_rng(4)
    x = _payload(rng, L.n_pad, DTYPES[dtype], dev)
    active = torch.from_numpy(rng.random(L.n_pad) < 0.5).to(dev)
    kern = ScatterKernel(L, monoid, DTYPES[dtype], dev)
    plain = ScatterKernel(L, monoid, DTYPES[dtype], dev, plain=True)
    before = _build.DC_GATHER.launches
    got = kern(x, active)
    torch.cuda.synchronize()
    assert _build.DC_GATHER.launches == before + 1
    _assert_bit_exact((got,), (plain(x, active),))


@pytest.fixture(scope="module")
def row_layouts(layouts):
    """Layouts for the regimes of ``dc_gather.cu``: k = 2 at the largest q
    its staged regime takes (``kMaxStagedQ`` = 46,480) and at the next
    multiple of 16 (its shared memory would pass 232,448 B), and msg_tile 30
    (not a multiple of 4: one slot at a time)."""
    rng = np.random.default_rng(11)
    out = {}
    for name, n in (("q46480", 92960), ("q46496", 92992)):
        src = np.repeat(np.arange(n), 4)
        g = from_edges(src, rng.integers(0, n, len(src)), n=n, dedup=True)
        out[name] = build_layout(g, k=2, q_mult=16, edge_tile=64,
                                 msg_tile=32)
    g = rmat(11, 8, seed=3, weighted=True)
    out["mt30"] = build_layout(g, k=8, edge_tile=64, msg_tile=30)
    assert (out["q46480"].q, out["q46496"].q) == (46480, 46496)
    return out


# case: (layout, the regime its shape takes)
DC_CASES = {"rmat": ("rmat", "staged"), "et128": ("et128", "staged"),
            "et1024": ("et1024", "staged"), "wide": ("wide", "l2"),
            "q46480": ("q46480", "staged"), "q46496": ("q46496", "l2"),
            "shuffled": ("rmat", "l2"), "mt30": ("mt30", "staged"),
            "unaligned": ("rmat", "staged"), "malformed": ("rmat", "staged")}


def _dc_slot_arrays(rng, case, L, kern, dev):
    """The slot arrays and pieces of one case, from the layout's."""
    local, valid, tile_part = (kern.png_src_local, kern.png_valid,
                               kern.png_tile_part)
    pieces = [kern.pieces]
    if case == "shuffled":   # no long runs: no pieces
        tp = rng.permutation(L.png_tile_part)
        assert dc_pieces(tp, q=L.q, msg_tile=L.msg_tile, blocks=132) is None
        tile_part, pieces = torch.from_numpy(tp).to(dev), [None]
    elif case == "unaligned":   # the slot arrays off a 16-byte boundary
        local, valid = _unaligned(local), _unaligned(valid)
    elif case == "malformed":
        # sources outside [0, q), and three tiles outside [0, k): pieces
        # built for them, and the layout's own (which the kernel finds do
        # not match and reads through L2)
        lc = L.png_src_local.copy()
        bad = rng.random(len(lc)) < 0.05
        lc[bad] = rng.choice([-1, -L.q, L.q, L.q + 7], int(bad.sum()))
        tp = L.png_tile_part.copy()
        tp[rng.choice(len(tp), 3, replace=False)] = [-1, L.k, L.k + 5]
        local, tile_part = (torch.from_numpy(a).to(dev) for a in (lc, tp))
        own = dc_pieces(tp, q=L.q, msg_tile=L.msg_tile, blocks=132)
        assert own is not None
        pieces = [torch.from_numpy(own).to(dev), kern.pieces]
    return (local, valid, tile_part), pieces


@pytest.mark.parametrize("case", sorted(DC_CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("monoid", MONOIDS)
def test_dc_gather_regimes_match_plain(dev, layouts, row_layouts, monoid,
                                       dtype, case):
    """``dc_gather.cu`` in both regimes, bit-exact with the plain version,
    with every source, half of them and none active; the regime counter
    moves as the shape says (staged: the layout's pieces, q % 16 == 0 and q
    <= 46,480; L2: no pieces, or a q past that)."""
    name, regime = DC_CASES[case]
    L = {**layouts, **row_layouts}[name]
    rng = np.random.default_rng(13)
    kern = ScatterKernel(L, monoid, DTYPES[dtype], dev)
    if case in ("q46496", "rmat"):   # pieces exist: q alone decides
        assert kern.pieces is not None
    slots, pieces = _dc_slot_arrays(rng, case, L, kern, dev)
    geo = dict(k=L.k, q=L.q, msg_tile=L.msg_tile, monoid=monoid)
    for density in (1.0, 0.5, 0.0):
        x = _payload(rng, L.n_pad, DTYPES[dtype], dev).view(L.k, L.q)
        active = torch.from_numpy(rng.random(L.n_pad) < density).to(
            dev).view(L.k, L.q)
        want = ref_dc_gather(x, active, *slots, **geo)
        for p in pieces:
            before = dict(_build.DC_GATHER.regimes)
            got = dc_gather_cuda(x, active, *slots, **geo, pieces=p)
            torch.cuda.synchronize()
            moved = {r: _build.DC_GATHER.regimes[r] - before[r]
                     for r in before}
            assert moved == {"l2": int(regime == "l2"),
                             "staged": int(regime == "staged")}
            _assert_bit_exact((got,), (want,))


def test_dc_gather_checks_its_pieces(dev, layouts):
    L = layouts["rmat"]
    kern = ScatterKernel(L, "add", torch.float32, dev)
    x = torch.zeros((L.k, L.q), device=dev)
    args = (x, torch.ones_like(x, dtype=torch.bool), kern.png_src_local,
            kern.png_valid, kern.png_tile_part)
    geo = dict(k=L.k, q=L.q, msg_tile=L.msg_tile)
    with pytest.raises(TypeError):
        dc_gather_cuda(*args, **geo, pieces=kern.pieces.to(torch.int32))
    with pytest.raises(ValueError):
        dc_gather_cuda(*args, **geo, pieces=kern.pieces.cpu())
    with pytest.raises(ValueError):
        dc_gather_cuda(*args, **geo, pieces=kern.pieces[:1])


@pytest.mark.parametrize("layout", ["rmat", "wide", "half"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("monoid", MONOIDS)
def test_segment_combine_kernel_matches_plain(dev, layouts, monoid, dtype,
                                              layout):
    """Random ``part_active`` (tiles skipped); ``half`` has partitions with
    no tiles, ``wide`` partitions wider than one block."""
    L = layouts[layout]
    rng = np.random.default_rng(5)
    vals = _payload(rng, L.num_edges, DTYPES[dtype], dev)
    valid = torch.from_numpy(L.edge_valid
                             & (rng.random(L.num_edges) < 0.7)).to(dev)
    part_active = torch.from_numpy(rng.random(L.k) < 0.6).to(dev)
    kern = GatherKernel(L, monoid, DTYPES[dtype], dev)
    plain = GatherKernel(L, monoid, DTYPES[dtype], dev, plain=True)
    before = _build.SEGMENT_COMBINE.launches
    got = kern(vals, valid, part_active)
    torch.cuda.synchronize()
    assert _build.SEGMENT_COMBINE.launches == before + 1
    _assert_bit_exact(got, plain(vals, valid, part_active))
    # the raw kernel writes a partition with no tiles as the identity
    raw = segment_combine_cuda(
        vals, valid, kern.edge_dst_local, kern.tile_src_part,
        kern.part_tile_off, part_active, k=L.k, q=L.q, edge_tile=L.edge_tile,
        monoid=monoid)
    _assert_bit_exact(raw, ref_segment_combine(
        vals, valid, kern.edge_dst_local, kern.tile_dst_part,
        kern.tile_src_part, kern.tile_first, part_active, k=L.k, q=L.q,
        edge_tile=L.edge_tile, monoid=monoid))


@pytest.mark.parametrize("layout", ["rmat", "wide", "half", "et128",
                                    "et1024", "sparse", "et24"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmv_block_kernel_matches_plain(dev, layouts, weighted, layout):
    L = layouts[layout]
    rng = np.random.default_rng(6)
    x = _payload(rng, L.n_pad, torch.float32, dev)
    kern = SpmvKernel(L, dev, weighted=weighted)
    plain = SpmvKernel(L, dev, weighted=weighted, plain=True)
    if weighted:                  # integer weights: exact in any order
        kern.edge_w = plain.edge_w = _payload(rng, L.num_edges,
                                              torch.float32, dev)
    before = _build.SPMV_BLOCK.launches
    got = kern(x)
    torch.cuda.synchronize()
    assert _build.SPMV_BLOCK.launches == before + 1
    _assert_bit_exact((got,), (plain(x),))


def _unaligned(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t)
    return buf[1:]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("layout", ["rmat", "wide", "et128", "et1024",
                                    "sparse", "et24"])
def test_spmv_block_paths_skip_dead_tiles(dev, layouts, layout, aligned):
    """Tiles whose source partition lies outside [0, k) add nothing, on both
    of the kernel's paths: the ring of bulk copies (edge_tile a multiple of
    16 and 16-byte aligned edge arrays), which must skip them without
    breaking its runs of live tiles, and plain loads (``et24``, or arrays
    that start off a 16-byte boundary)."""
    L = layouts[layout]
    rng = np.random.default_rng(10)
    kern = SpmvKernel(L, dev, weighted=True)
    w = _payload(rng, L.num_edges, torch.float32, dev)
    x = _payload(rng, L.n_pad, torch.float32, dev).view(L.k, L.q)
    tsp = L.tile_src_part.copy()
    dead = rng.random(len(tsp)) < 0.3
    tsp[dead] = np.where(rng.random(int(dead.sum())) < 0.5, -1, L.k)
    tsp = torch.from_numpy(tsp).to(dev)
    geo = dict(k=L.k, q=L.q, edge_tile=L.edge_tile, weighted=True)
    args = (x, kern.edge_src_local, kern.edge_dst_local, kern.edge_valid, w)
    if not aligned:
        args = (x, *(_unaligned(a) for a in args[1:]))
    before = _build.SPMV_BLOCK.launches
    got = spmv_block_cuda(*args, tsp, kern.part_tile_off, **geo)
    torch.cuda.synchronize()
    assert _build.SPMV_BLOCK.launches == before + 1
    want = ref_spmv_block(*args, kern.tile_dst_part, tsp, kern.tile_first,
                          **geo)
    _assert_bit_exact((got,), (want,))


@pytest.mark.parametrize("layout", ["rmat", "half"])
def test_unweighted_spmv_equals_fused_add(dev, layouts, layout):
    """``y = A^T x`` two ways on the card: the SpMV kernel, and the fused
    DC kernel's add over a table that is all valid but its sentinel."""
    L = layouts[layout]
    x = _payload(np.random.default_rng(7), L.n_pad + 1, torch.float32, dev)
    table_valid = torch.ones(L.n_pad + 1, dtype=torch.bool, device=dev)
    table_valid[-1] = False
    acc, _ = FusedDCKernel(L, "add", torch.float32, dev)(x, table_valid)
    y = SpmvKernel(L, dev, weighted=False)(x[:L.n_pad])
    _assert_bit_exact((y,), (acc[:L.n_pad],))


def test_new_wrappers_check_their_inputs(dev, layouts):
    L = layouts["rmat"]
    kern = GatherKernel(L, "min", torch.float32, dev)
    vals = torch.zeros(L.num_edges, device=dev)
    valid = torch.ones(L.num_edges, dtype=torch.bool, device=dev)
    active = torch.ones(L.k, dtype=torch.bool, device=dev)
    args = (kern.edge_dst_local, kern.tile_src_part, kern.part_tile_off)
    geom = dict(k=L.k, q=L.q, edge_tile=L.edge_tile, monoid="min")
    with pytest.raises(ValueError):
        segment_combine_cuda(vals[:-1], valid, *args, active, **geom)
    with pytest.raises(TypeError):
        segment_combine_cuda(vals, valid.to(torch.int32), *args, active,
                             **geom)
    x = torch.zeros((L.k, L.q), device=dev)
    sk = ScatterKernel(L, "min", torch.float32, dev)
    with pytest.raises(ValueError):
        dc_gather_cuda(x, torch.ones_like(x, dtype=torch.bool),
                       sk.png_src_local, sk.png_valid, sk.png_tile_part,
                       k=L.k, q=L.q, msg_tile=L.msg_tile + 1)
    with pytest.raises(ValueError):
        ref_dc_gather(x, x, sk.png_src_local, sk.png_valid, sk.png_tile_part,
                      k=L.k, q=L.q, msg_tile=L.msg_tile, monoid="nope")


def test_composed_apps_on_the_card_match_the_cpu(dev, monkeypatch):
    """``REPRO_FUSED=0``: the composed DC path on the card against the CPU,
    and against the fused path on the card."""
    g = rmat(10, 8, seed=5, weighted=True)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    S = build_layout(symmetrize(g), k=8, edge_tile=64, msg_tile=32)
    src = int(np.argmax(g.out_degrees()))
    fused = {"bfs": rt.bfs(L, src), "sssp": rt.sssp(L, src),
             "cc": rt.connected_components(S), "pr": rt.pagerank(L)}
    monkeypatch.setenv("REPRO_FUSED", "0")
    before = _build.DC_GATHER.launches, _build.SEGMENT_COMBINE.launches
    for mode in ("hybrid", "dc"):
        a, b = rt.bfs(L, src, mode=mode), rt.bfs(L, src, mode=mode,
                                                 device="cpu")
        assert np.array_equal(a["level"], b["level"])
        assert np.array_equal(a["parent"], b["parent"])
        a, b = rt.sssp(L, src, mode=mode), rt.sssp(L, src, mode=mode,
                                                   device="cpu")
        assert np.array_equal(a["dist"], b["dist"])
    assert _build.DC_GATHER.launches > before[0]
    assert _build.SEGMENT_COMBINE.launches > before[1]
    assert np.array_equal(rt.bfs(L, src)["parent"], fused["bfs"]["parent"])
    assert np.array_equal(rt.sssp(L, src)["dist"], fused["sssp"]["dist"])
    cc = rt.connected_components(S)["label"]
    assert np.array_equal(
        cc, rt.connected_components(S, device="cpu")["label"])
    assert np.array_equal(cc, fused["cc"]["label"])
    pr = rt.pagerank(L)["pr"]
    np.testing.assert_allclose(pr, rt.pagerank(L, device="cpu")["pr"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pr, fused["pr"]["pr"], rtol=0, atol=1e-6)


def _dead_tiles(rng, L, device):
    """``tile_src_part`` with about 30 % of its tiles moved outside [0, k)."""
    tsp = L.tile_src_part.copy()
    dead = rng.random(len(tsp)) < 0.3
    tsp[dead] = np.where(rng.random(int(dead.sum())) < 0.5, -1, L.k)
    return torch.from_numpy(tsp).to(device)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("layout", ["rmat", "wide", "half", "et128",
                                    "et1024", "sparse", "et24"])
def test_fused_dc_tile_paths_match_plain(dev, layouts, layout, aligned):
    """Every monoid x dtype, and f32 ``add_weight``, on both of the kernel's
    paths (the ring: ``edge_tile`` a multiple of 16 and 16-byte aligned edge
    arrays; plain loads: ``et24`` or arrays off a 16-byte boundary), with
    tiles whose source partition lies outside [0, k) (their sources clamp
    into the table, as the reference's ``idx`` does); ``wide`` has
    partitions wider than ``MAX_CHUNK``."""
    L = layouts[layout]
    rng = np.random.default_rng(11)
    kern = FusedDCKernel(L, "add", torch.float32, dev)
    tsp = _dead_tiles(rng, L, dev)
    w = _payload(rng, L.num_edges, torch.float32, dev)
    arrays = (kern.edge_src_local, kern.edge_dst_local, kern.edge_valid, w)
    if not aligned:
        arrays = tuple(_unaligned(a) for a in arrays)
    src_local, dst_local, edge_valid, w = arrays
    tiles = EdgeTiles(src_local, dst_local, tsp, kern.part_tile_off, L.q,
                      L.edge_tile)
    idx, dst = global_edges(tsp, kern.tile_dst_part, src_local, dst_local,
                            edge_valid, q=L.q, edge_tile=L.edge_tile,
                            n_pad=L.n_pad)
    ns = L.n_pad + 1
    cases = [(m, d, None) for m in MONOIDS for d in DTYPES]
    cases += [("min", "float32", add_weight), ("add", "float32", add_weight)]
    for monoid, dtype, fn in cases:
        table = _payload(rng, ns, DTYPES[dtype], dev)
        tvalid = torch.from_numpy(rng.random(ns) < 0.6).to(dev)
        wt = w if fn is not None else None
        before = _build.FUSED_DC.launches
        got = fused_dc_cuda(table, tvalid, edge_valid, ns, monoid, tiles,
                            apply_weight=fn, w=wt)
        torch.cuda.synchronize()
        assert _build.FUSED_DC.launches == before + 1
        want = ref_fused_scatter_fold(M.REGISTRY[monoid](DTYPES[dtype]),
                                      table, tvalid, idx, edge_valid, dst,
                                      ns, apply_weight=fn, w=wt)
        _assert_bit_exact(got, want)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("layout", ["rmat", "wide", "half", "et128",
                                    "et1024", "sparse", "et24"])
def test_segment_combine_tile_paths_match_plain(dev, layouts, layout,
                                                aligned):
    """Every monoid x dtype on both of the kernel's paths, with dead tiles
    (source partition outside [0, k)) and inactive source partitions, which
    the ring's producer skips."""
    L = layouts[layout]
    rng = np.random.default_rng(12)
    kern = GatherKernel(L, "add", torch.float32, dev)
    tsp = _dead_tiles(rng, L, dev)
    geo = dict(k=L.k, q=L.q, edge_tile=L.edge_tile)
    for monoid in MONOIDS:
        for dtype in DTYPES.values():
            vals = _payload(rng, L.num_edges, dtype, dev)
            valid = torch.from_numpy(L.edge_valid & (
                rng.random(L.num_edges) < 0.8)).to(dev)
            dst_local = kern.edge_dst_local
            if not aligned:
                vals, valid, dst_local = (_unaligned(a) for a in
                                          (vals, valid, dst_local))
            part_active = torch.from_numpy(rng.random(L.k) < 0.6).to(dev)
            before = _build.SEGMENT_COMBINE.launches
            got = segment_combine_cuda(vals, valid, dst_local, tsp,
                                       kern.part_tile_off, part_active,
                                       monoid=monoid, **geo)
            torch.cuda.synchronize()
            assert _build.SEGMENT_COMBINE.launches == before + 1
            _assert_bit_exact(got, ref_segment_combine(
                vals, valid, dst_local, kern.tile_dst_part, tsp,
                kern.tile_first, part_active, monoid=monoid, **geo))


def _star(n=4096, k=8):
    """Every vertex of the upper half points at vertex 5, a hub in
    partition 0, and one ring of edges keeps the other partitions live."""
    src = np.concatenate([np.arange(n // 2, n), np.arange(n)])
    dst = np.concatenate([np.full(n // 2, 5), (np.arange(n) * 7 + 1) % n])
    return build_layout(from_edges(src, dst, n=n, dedup=True), k=k,
                        edge_tile=64, msg_tile=32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_zero_payloads_on_a_star_hub_come_out_touched(dev, dtype):
    """Zero payloads into a hub that the warps' register caches take: the
    hub's sum is the identity, and it must come out touched, from both tile
    kernels, as it does from their plain versions."""
    L = _star()
    ns = L.n_pad + 1
    zeros = torch.zeros(ns, dtype=torch.int32, device=dev).view(DTYPES[dtype])
    ok = torch.ones(ns, dtype=torch.bool, device=dev)
    kern = FusedDCKernel(L, "add", DTYPES[dtype], dev)
    plain = FusedDCKernel(L, "add", DTYPES[dtype], dev, plain=True)
    got = kern(zeros, ok)
    _assert_bit_exact(got, plain(zeros, ok))
    assert bool(got[1][5])
    gk = GatherKernel(L, "add", DTYPES[dtype], dev)
    gp = GatherKernel(L, "add", DTYPES[dtype], dev, plain=True)
    vals = zeros[:1].expand(L.num_edges).contiguous()
    valid = torch.from_numpy(L.edge_valid).to(dev)
    parts = torch.ones(L.k, dtype=torch.bool, device=dev)
    got = gk(vals, valid, parts)
    _assert_bit_exact(got, gp(vals, valid, parts))
    assert bool(got[1][5])


@pytest.mark.parametrize("fused", ["1", "0"])
def test_apps_on_both_lowerings_match_the_plain_route(dev, monkeypatch,
                                                      fused):
    """BFS, SSSP, CC and PageRank through the kernels and through the plain
    versions on the card (``Engine(plain=True)``), on the fused and the
    composed DC lowering."""
    monkeypatch.setenv("REPRO_FUSED", fused)
    g = rmat(10, 8, seed=6, weighted=True)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    S = build_layout(symmetrize(g), k=8, edge_tile=64, msg_tile=32)
    src = int(np.argmax(g.out_degrees()))
    runs = {"bfs": (rt.bfs, rt.apps.bfs_program(), L, ("level", "parent")),
            "sssp": (rt.sssp, rt.apps.sssp_program(), L, ("dist",)),
            "cc": (rt.connected_components, rt.apps.cc_program(), S,
                   ("label",))}
    for name, (app, program, lay, keys) in runs.items():
        eng = rt.Engine(lay, program, plain=True)
        assert eng.fused == (fused == "1")
        args = (lay,) if name == "cc" else (lay, src)
        a, b = app(*args), app(*args, engine=eng)
        for key in keys:
            assert np.array_equal(a[key], b[key]), (name, key)
    eng = rt.Engine(L, rt.apps.pagerank_program(g.n), mode="dc", plain=True)
    np.testing.assert_allclose(rt.pagerank(L)["pr"],
                               rt.pagerank(L, engine=eng)["pr"], rtol=0,
                               atol=1e-6)


# ---- the lane forms of the batched engine: one launch for B lanes ----

LANE_CASES = [(m, d) for m in MONOIDS for d in sorted(DTYPES)]


def _lanes_unaligned(t):
    """``_unaligned`` for a ``[B, ...]`` tensor: its rows stay contiguous."""
    return _unaligned(t.reshape(-1)).view(t.shape)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [1, 3, 16])
@pytest.mark.parametrize("layout", ["rmat", "wide", "half", "et24"])
def test_fused_dc_lanes_match_plain(dev, layouts, layout, lanes, aligned):
    """``fused_dc_lanes`` against the plain lane version, every monoid x
    dtype and f32 ``add_weight``: one launch for all lanes, lane 0 with no
    valid source; ``wide`` splits partitions (q > MAX_CHUNK), ``et24`` and
    the tables off a 16-byte boundary (the edges too, whose plain loads
    then serve every lane) take plain loads."""
    L = layouts[layout]
    rng = np.random.default_rng(30 + lanes)
    kern = FusedDCKernel(L, "add", torch.float32, dev)
    w = _payload(rng, L.num_edges, torch.float32, dev)
    arrays = (kern.edge_src_local, kern.edge_dst_local, kern.edge_valid, w)
    if not aligned:
        arrays = tuple(_unaligned(a) for a in arrays)
    src_local, dst_local, edge_valid, w = arrays
    tiles = EdgeTiles(src_local, dst_local, kern.tile_src_part,
                      kern.part_tile_off, L.q, L.edge_tile)
    idx, dst = global_edges(kern.tile_src_part, kern.tile_dst_part, src_local,
                            dst_local, edge_valid, q=L.q,
                            edge_tile=L.edge_tile, n_pad=L.n_pad)
    le = build_lane_edges(tiles, edge_valid, w)
    ns = L.n_pad + 1
    cases = [(m, d, None) for m, d in LANE_CASES]
    cases += [("min", "float32", add_weight)]
    for monoid, dtype, fn in cases:
        table = _payload(rng, lanes * ns, DTYPES[dtype], dev).view(lanes, ns)
        tvalid = torch.from_numpy(rng.random((lanes, ns)) < 0.6).to(dev)
        tvalid[0] = False
        if not aligned:
            table, tvalid = _lanes_unaligned(table), _lanes_unaligned(tvalid)
        wt = w if fn is not None else None
        before = (_build.FUSED_DC.launches, _build.FUSED_DC_LANES.launches)
        got = fused_dc_cuda(table, tvalid, edge_valid, ns, monoid, tiles,
                            apply_weight=fn, w=wt, lane_edges=le)
        torch.cuda.synchronize()
        assert (_build.FUSED_DC.launches,
                _build.FUSED_DC_LANES.launches) == (before[0], before[1] + 1)
        want = ref_fused_scatter_fold(M.REGISTRY[monoid](DTYPES[dtype]),
                                      table, tvalid, idx, edge_valid, dst,
                                      ns, apply_weight=fn, w=wt)
        _assert_bit_exact(got, want)
        assert not got[1][0].any()
        if lanes > 1:   # each lane is its own single-lane launch
            _assert_bit_exact(
                (got[0][1], got[1][1]),
                fused_dc_cuda(table[1].contiguous(), tvalid[1].contiguous(),
                              edge_valid, ns, monoid, tiles, apply_weight=fn,
                              w=wt))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lanes", [1, 3, 16])
@pytest.mark.parametrize("layout", ["rmat", "wide", "half", "et24"])
def test_segment_combine_lanes_match_plain(dev, layouts, layout, lanes,
                                           aligned):
    """``segment_combine_lanes`` against the plain lane version, every
    monoid x dtype, each lane with its own inactive source partitions (lane
    0 with none active); ``et24`` (lanes 16-byte aligned only where the
    edge count allows) and streams off a 16-byte boundary take plain
    loads."""
    L = layouts[layout]
    rng = np.random.default_rng(40 + lanes)
    kern = GatherKernel(L, "add", torch.float32, dev)
    tsp = _dead_tiles(rng, L, dev)
    geo = dict(k=L.k, q=L.q, edge_tile=L.edge_tile)
    ne = L.num_edges
    for monoid, dtype in LANE_CASES:
        vals = _payload(rng, lanes * ne, DTYPES[dtype], dev).view(lanes, ne)
        valid = torch.from_numpy(L.edge_valid & (
            rng.random((lanes, ne)) < 0.8)).to(dev)
        part_active = torch.from_numpy(rng.random((lanes, L.k)) < 0.6).to(dev)
        part_active[0] = False
        if not aligned:
            vals, valid = _lanes_unaligned(vals), _lanes_unaligned(valid)
        before = (_build.SEGMENT_COMBINE.launches,
                  _build.SEGMENT_COMBINE_LANES.launches)
        got = segment_combine_cuda(vals, valid, kern.edge_dst_local, tsp,
                                   kern.part_tile_off, part_active,
                                   monoid=monoid, **geo)
        torch.cuda.synchronize()
        assert (_build.SEGMENT_COMBINE.launches,
                _build.SEGMENT_COMBINE_LANES.launches) == (before[0],
                                                           before[1] + 1)
        _assert_bit_exact(got, ref_segment_combine(
            vals, valid, kern.edge_dst_local, kern.tile_dst_part, tsp,
            kern.tile_first, part_active, monoid=monoid, **geo))
        assert not got[1][0].any()


# case: (layout, the regime its shape takes)
DC_LANE_CASES = {"rmat": ("rmat", "staged"), "wide": ("wide", "l2"),
                 "shuffled": ("rmat", "l2"), "q46480": ("q46480", "staged"),
                 "mt30": ("mt30", "staged"), "unaligned": ("rmat", "staged")}


@pytest.mark.parametrize("case", sorted(DC_LANE_CASES))
@pytest.mark.parametrize("lanes", [1, 3, 16])
def test_dc_gather_lanes_regimes_match_plain(dev, layouts, row_layouts, lanes,
                                             case):
    """``dc_gather_lanes`` in both regimes against the plain lane version,
    every monoid x dtype, lanes with every source, half of them and none
    active; the regime counter moves once per launch, as the shape says."""
    name, regime = DC_LANE_CASES[case]
    L = {**layouts, **row_layouts}[name]
    rng = np.random.default_rng(50 + lanes)
    for monoid, dtype in LANE_CASES:
        kern = ScatterKernel(L, monoid, DTYPES[dtype], dev)
        slots, pieces = _dc_slot_arrays(rng, case, L, kern, dev)
        geo = dict(k=L.k, q=L.q, msg_tile=L.msg_tile, monoid=monoid)
        x = _payload(rng, lanes * L.n_pad, DTYPES[dtype], dev).view(
            lanes, L.k, L.q)
        density = np.array([0.0, 0.5, 1.0])[np.arange(lanes) % 3]
        active = torch.from_numpy(
            rng.random((lanes, L.n_pad)) < density[:, None]).to(dev).view(
            lanes, L.k, L.q)
        want = ref_dc_gather(x, active, *slots, **geo)
        for p in pieces:
            before = dict(_build.DC_GATHER_LANES.regimes)
            got = dc_gather_cuda(x, active, *slots, **geo, pieces=p)
            torch.cuda.synchronize()
            moved = {r: _build.DC_GATHER_LANES.regimes[r] - before[r]
                     for r in before}
            assert moved == {"l2": int(regime == "l2"),
                             "staged": int(regime == "staged")}
            _assert_bit_exact((got,), (want,))


def test_lane_wrappers_check_their_inputs(dev, layouts):
    """A non-contiguous ``[B, ...]`` input, or one of the wrong shape,
    raises before any launch."""
    L = layouts["rmat"]
    ns, ne = L.n_pad + 1, L.num_edges
    fk = FusedDCKernel(L, "min", torch.float32, dev)
    table = torch.zeros((4, ns), device=dev)
    valid = torch.ones((4, ns), dtype=torch.bool, device=dev)
    before = _build.FUSED_DC_LANES.launches
    with pytest.raises(ValueError, match="contiguous"):
        fk(table.t().contiguous().t(), valid)      # [4, ns], column-major
    with pytest.raises(ValueError, match="contiguous"):
        fk(torch.zeros((ns, 4), device=dev).t(), valid)
    with pytest.raises(ValueError, match="shape"):
        fk(table, valid[:3])
    with pytest.raises(ValueError, match="B, M"):
        fk(table[:0], valid[:0])
    with pytest.raises(ValueError, match="B, M"):
        fk(table.view(2, 2, ns), valid.view(2, 2, ns))
    assert _build.FUSED_DC_LANES.launches == before
    gk = GatherKernel(L, "min", torch.float32, dev)
    vals = torch.zeros((4, ne), device=dev)
    evalid = torch.ones((4, ne), dtype=torch.bool, device=dev)
    parts = torch.ones((4, L.k), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="shape"):
        gk(vals, evalid, parts[0])
    with pytest.raises(ValueError, match="contiguous"):
        gk(vals, evalid, torch.ones((L.k, 4), dtype=torch.bool,
                                    device=dev).t())
    with pytest.raises(ValueError, match="shape"):
        gk(vals, evalid[:, :-1], parts)
    sk = ScatterKernel(L, "min", torch.float32, dev)
    x = torch.zeros((4, L.k, L.q), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        dc_gather_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                       torch.ones_like(x, dtype=torch.bool),
                       sk.png_src_local, sk.png_valid, sk.png_tile_part,
                       k=L.k, q=L.q, msg_tile=L.msg_tile)
    with pytest.raises(ValueError, match="shape"):
        dc_gather_cuda(x, torch.ones((3, L.k, L.q), dtype=torch.bool,
                                     device=dev),
                       sk.png_src_local, sk.png_valid, sk.png_tile_part,
                       k=L.k, q=L.q, msg_tile=L.msg_tile)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_batched_apps_on_the_card_match_the_cpu(dev, monkeypatch, fused):
    """``bfs_multi`` and ``sssp_multi`` (16 lanes) on the card, on both DC
    lowerings, bit-exact with the CPU and with sequential runs on the card;
    every batched step launched each lane kernel of its lowering once, and
    nothing else."""
    monkeypatch.setenv("REPRO_FUSED", fused)
    g = rmat(10, 8, seed=5, weighted=True)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    sources = np.linspace(0, L.n - 1, 16).astype(np.int64)
    lane_kernels = ((_build.FUSED_DC_INTERLEAVE, _build.FUSED_DC_LANES)
                    if fused == "1" else
                    (_build.DC_GATHER_LANES, _build.SEGMENT_COMBINE_LANES))
    for app, keys in ((rt.bfs_multi, ("level", "parent")),
                      (rt.sssp_multi, ("dist",))):
        _build.reset_launch_counts()
        got = app(L, sources)
        steps = len(got["stats"])
        counts = {k.name: k.launches for k in _build.KERNELS}
        assert counts == {k.name: steps if k in lane_kernels else 0
                          for k in _build.KERNELS}
        if fused == "0":
            assert _build.DC_GATHER_LANES.regimes["staged"] == steps
        cpu = app(L, sources, device="cpu")
        for key in keys:
            assert np.array_equal(got[key], cpu[key]), key
        seq = rt.bfs if app is rt.bfs_multi else rt.sssp
        for i in (0, 7, 15):
            one = seq(L, int(sources[i]))
            for key in keys:
                assert np.array_equal(got[key][i], one[key]), (key, i)


def test_local_apps_on_the_card_match_the_cpu(dev):
    """Nibble, heat-kernel PageRank and PageRank-Nibble on the card against
    the CPU (f32 adds in another order: within 1e-6)."""
    g = rmat(10, 8, seed=5)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    src = int(np.argmax(g.out_degrees()))
    for app, key in ((rt.nibble, "pr"), (rt.heat_kernel_pr, "hkpr"),
                     (rt.pagerank_nibble, "ppr")):
        np.testing.assert_allclose(app(L, src)[key],
                                   app(L, src, device="cpu")[key], rtol=0,
                                   atol=1e-6)


# ---- the 8-byte min: the packed words of min_with_payload, as int64 ----

def _packed(rng, n, device):
    """Packed ``(f32 key << 32) | payload`` words: random non-negative f32
    keys (not only integer-valued), a tenth +inf, any uint32 payload."""
    keys = rng.random(n, dtype=np.float32) * np.float32(1000)
    keys[rng.random(n) < 0.1] = np.inf
    payload = rng.integers(0, 2**32, n, dtype=np.int64)
    words = (keys.view(np.int32).astype(np.int64) << 32) | payload
    return torch.from_numpy(words).to(device)


@pytest.fixture(scope="module")
def wide_layouts(layouts):
    """``q32k``: k = 4 partitions of q = 32,768, the main path's q, which
    the 8-byte tile kernels split into two slices of 16,384."""
    return {**layouts,
            "q32k": build_layout(rmat(17, 2, seed=6, weighted=True), k=4,
                                 edge_tile=64, msg_tile=32)}


# both regimes of the 8-byte fold (shared memory up to 22,752 segments,
# kSharedMaxSegments<long long>, global atomics past it), the boundary on
# both sides, and a tiny count
@pytest.mark.parametrize("ns", [7, 4096, 22752, 22753, 300_001])
@pytest.mark.parametrize("monoid", ["min", "min_with_payload"])
def test_wide_segment_fold_matches_plain(dev, monoid, ns):
    rng = np.random.default_rng(60)
    n = 200_000
    vals = _packed(rng, n, dev)
    valid = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    ids = torch.from_numpy(
        rng.integers(-8, ns + 8, n).astype(np.int32)).to(dev)
    before = _build.SEGMENT_FOLD.launches
    got = segment_fold_cuda(vals, valid, ids, ns, monoid)
    torch.cuda.synchronize()
    assert _build.SEGMENT_FOLD.launches == before + 1
    _assert_bit_exact(got, segment_fold(vals, valid, ids, ns, monoid))
    sorted_ids = torch.sort(ids.clamp(0, ns - 1)).values
    _assert_bit_exact(segment_fold_cuda(vals, valid, sorted_ids, ns, monoid),
                      segment_fold(vals, valid, sorted_ids, ns, monoid))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("layout", ["rmat", "wide", "half", "sparse", "et24",
                                    "q32k"])
def test_wide_fused_dc_matches_plain(dev, wide_layouts, layout, aligned):
    """The 8-byte min with no edge function and with
    ``add_weight_to_key`` on both paths of the kernel (the ring; plain
    loads on ``et24`` or arrays off a 16-byte boundary), single lane and B
    = 3 and 16, with dead tiles; ``q32k`` and ``wide`` split each partition
    into slices of 16,384."""
    L = wide_layouts[layout]
    rng = np.random.default_rng(61)
    kern = FusedDCKernel(L, "min", torch.int64, dev)
    tsp = _dead_tiles(rng, L, dev)
    w = torch.from_numpy(rng.random(L.num_edges, dtype=np.float32)
                         * np.float32(10)).to(dev)
    arrays = (kern.edge_src_local, kern.edge_dst_local, kern.edge_valid, w)
    if not aligned:
        arrays = tuple(_unaligned(a) for a in arrays)
    src_local, dst_local, edge_valid, w = arrays
    tiles = EdgeTiles(src_local, dst_local, tsp, kern.part_tile_off, L.q,
                      L.edge_tile)
    idx, dst = global_edges(tsp, kern.tile_dst_part, src_local, dst_local,
                            edge_valid, q=L.q, edge_tile=L.edge_tile,
                            n_pad=L.n_pad)
    ns = L.n_pad + 1
    le = build_lane_edges(tiles, edge_valid, w)
    mono = M.min_with_payload()
    for lanes in (None, 3, 16):
        shape = (ns,) if lanes is None else (lanes, ns)
        for fn in (None, add_weight_to_key):
            table = _packed(rng, int(np.prod(shape)), dev).view(shape)
            tvalid = torch.from_numpy(rng.random(shape) < 0.6).to(dev)
            wt = w if fn is not None else None
            kk = _build.FUSED_DC if lanes is None else _build.FUSED_DC_LANES
            before = kk.launches
            got = fused_dc_cuda(table, tvalid, edge_valid, ns,
                                "min_with_payload", tiles, apply_weight=fn,
                                w=wt, lane_edges=le)
            torch.cuda.synchronize()
            assert kk.launches == before + 1
            _assert_bit_exact(got, ref_fused_scatter_fold(
                mono, table, tvalid, idx, edge_valid, dst, ns,
                apply_weight=fn, w=wt))


@pytest.mark.parametrize("lanes", [1, 4, 16, 40])
@pytest.mark.parametrize("layout", ["rmat", "wide", "sparse", "q32k"])
def test_fused_dc_lane_groups_match_plain(dev, wide_layouts, layout, lanes):
    """The lane form over the layout's edge copy, built once: ``lane_group``
    lanes a block (W = 40: groups of 8 and two mask words), every 4-byte
    monoid x dtype, f32 ``add_weight`` and the 8-byte min with and without
    ``add_weight_to_key``, bit-exact with the plain lane version; the
    interleaving launch bit-exact with ``ref_interleave_lanes``; one launch
    of each a call."""
    L = wide_layouts[layout]
    rng = np.random.default_rng(70 + lanes)
    kern = FusedDCKernel(L, "min", torch.float32, dev)
    tiles, ev = kern.tiles, kern.edge_valid
    w = torch.from_numpy(rng.random(L.num_edges, dtype=np.float32)
                         * np.float32(10)).to(dev)
    le = build_lane_edges(tiles, ev, w)
    assert int(le.off[-1]) == le.src.numel() == int(ev.sum())
    idx, dst = global_edges(kern.tile_src_part, kern.tile_dst_part,
                            kern.edge_src_local, kern.edge_dst_local, ev,
                            q=L.q, edge_tile=L.edge_tile, n_pad=L.n_pad)
    ns = L.n_pad + 1
    assert lane_group(lanes) == {1: 1, 4: 4, 16: 16, 40: 8}[lanes]
    cases = [(m, DTYPES[d], None) for m, d in LANE_CASES]
    cases += [("min", torch.float32, add_weight),
              ("min_with_payload", torch.int64, None),
              ("min_with_payload", torch.int64, add_weight_to_key)]
    for monoid, dtype, fn in cases:
        if dtype == torch.int64:
            table = _packed(rng, lanes * ns, dev).view(lanes, ns)
        else:
            table = _payload(rng, lanes * ns, dtype, dev).view(lanes, ns)
        tvalid = torch.from_numpy(rng.random((lanes, ns)) < 0.6).to(dev)
        tvalid[0] = False
        wt = w if fn is not None else None
        before = (_build.FUSED_DC_INTERLEAVE.launches,
                  _build.FUSED_DC_LANES.launches)
        got = fused_dc_cuda(table, tvalid, ev, ns, monoid, tiles,
                            apply_weight=fn, w=wt, lane_edges=le)
        torch.cuda.synchronize()
        assert (_build.FUSED_DC_INTERLEAVE.launches,
                _build.FUSED_DC_LANES.launches) == (before[0] + 1,
                                                    before[1] + 1)
        _assert_bit_exact(got, ref_fused_scatter_fold(
            M.make(monoid, dtype), table, tvalid, idx, ev, dst, ns,
            apply_weight=fn, w=wt))
        assert not got[1][0].any()
        for rank in (le.rank, None):   # the copy's rows, and none
            il = torch.empty((ns, lanes), dtype=dtype, device=dev)
            mask = torch.empty((ns, -(-lanes // 32)), dtype=torch.int32,
                               device=dev)
            _build.FUSED_DC_INTERLEAVE.launch(
                table.data_ptr(), tvalid.data_ptr(), ns, ns, lanes,
                table.element_size(),
                rank.data_ptr() if rank is not None else None,
                il.data_ptr(), mask.data_ptr(), _build.stream_handle(dev))
            torch.cuda.synchronize()
            _assert_bit_exact((il, mask),
                              ref_interleave_lanes(table, tvalid, rank))


def test_fused_dc_lane_form_refuses_what_it_cannot_take(dev, layouts):
    """No edge copy, an edge copy built from other arrays than the call's,
    a table of other than k*q + 1 entries, and C-level shapes the lane fold
    does not take (a group that does not divide the lanes, a width not a
    multiple of fine, a sub-slice past shared memory), raise before a
    launch."""
    L = layouts["rmat"]
    ns = L.n_pad + 1
    fk = FusedDCKernel(L, "min", torch.float32, dev)
    le = build_lane_edges(fk.tiles, fk.edge_valid)
    table = torch.zeros((4, ns), device=dev)
    valid = torch.ones((4, ns), dtype=torch.bool, device=dev)
    w = torch.ones(L.num_edges, device=dev)
    counts = {k.name: k.launches for k in _build.KERNELS}
    with pytest.raises(ValueError, match="lane copy"):
        fused_dc_cuda(table, valid, fk.edge_valid, ns, "min", fk.tiles)
    with pytest.raises(ValueError, match="built from"):
        fused_dc_cuda(table, valid, fk.edge_valid.clone(), ns, "min",
                      fk.tiles, lane_edges=le)
    with pytest.raises(ValueError, match="built from"):
        fused_dc_cuda(table, valid, fk.edge_valid, ns, "min", fk.tiles,
                      apply_weight=add_weight, w=w, lane_edges=le)
    with pytest.raises(ValueError, match="k\\*q \\+ 1"):
        fused_dc_cuda(table[:, :-1].contiguous(), valid[:, :-1].contiguous(),
                      fk.edge_valid, ns, "min", fk.tiles, lane_edges=le)
    il = torch.zeros((ns, 4), device=dev)
    mask = torch.zeros((ns, 1), dtype=torch.int32, device=dev)
    acc = torch.empty((4, ns), device=dev)
    touched = torch.empty((4, ns), dtype=torch.bool, device=dev)
    width = lane_width(4, 4, L.q)
    for lanes, fine, wd, group in ((4, le.fine, width, 3),
                                   (4, le.fine, width + 1, 4),
                                   (4, le.fine, 128 * le.fine, 4)):
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.FUSED_DC_LANES.launch(
                il.data_ptr(), mask.data_ptr(), ns, lanes, le.src.data_ptr(),
                le.dst.data_ptr(), None, le.off.data_ptr(), L.k, L.q, fine,
                wd, group, ns, ns, _build.MONOID_CODES["min"],
                _build.DTYPE_CODES[torch.float32], 0, acc.data_ptr(),
                touched.data_ptr(), _build.stream_handle(dev))
    assert counts == {k.name: k.launches for k in _build.KERNELS}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("layout", ["rmat", "wide", "half", "sparse", "et24",
                                    "q32k"])
def test_wide_segment_combine_matches_plain(dev, wide_layouts, layout,
                                            aligned):
    """The 8-byte min on both paths, single lane and B = 3 and 16 (each
    lane with its own inactive source partitions), with dead tiles."""
    L = wide_layouts[layout]
    rng = np.random.default_rng(62)
    kern = GatherKernel(L, "min", torch.int64, dev)
    tsp = _dead_tiles(rng, L, dev)
    geo = dict(k=L.k, q=L.q, edge_tile=L.edge_tile)
    dst_local = kern.edge_dst_local
    view = (lambda a: a) if aligned else _lanes_unaligned
    for lanes in (None, 3, 16):
        lead = () if lanes is None else (lanes,)
        n = int(np.prod(lead + (L.num_edges,)))
        vals = view(_packed(rng, n, dev).view(lead + (L.num_edges,)))
        valid = view(torch.from_numpy(
            rng.random(lead + (L.num_edges,)) < 0.8).to(dev))
        part_active = torch.from_numpy(rng.random(lead + (L.k,)) < 0.6).to(dev)
        kk = (_build.SEGMENT_COMBINE if lanes is None
              else _build.SEGMENT_COMBINE_LANES)
        before = kk.launches
        got = segment_combine_cuda(
            vals, valid, dst_local if aligned else _unaligned(dst_local),
            tsp, kern.part_tile_off, part_active, monoid="min_with_payload",
            **geo)
        torch.cuda.synchronize()
        assert kk.launches == before + 1
        _assert_bit_exact(got, ref_segment_combine(
            vals, valid, dst_local, kern.tile_dst_part, tsp, kern.tile_first,
            part_active, monoid="min_with_payload", **geo))


@pytest.mark.parametrize("lanes", [None, 3, 16])
@pytest.mark.parametrize("layout", ["rmat", "wide", "q32k"])
def test_wide_dc_gather_takes_the_l2_regime(dev, wide_layouts, layout,
                                            lanes):
    """8-byte words without pieces: the L2 regime, bit-exact, the identity
    INT64_MAX on inactive slots."""
    L = wide_layouts[layout]
    rng = np.random.default_rng(63)
    kern = ScatterKernel(L, "min_with_payload", torch.int64, dev)
    slots = (kern.png_src_local, kern.png_valid, kern.png_tile_part)
    geo = dict(k=L.k, q=L.q, msg_tile=L.msg_tile, monoid="min_with_payload")
    lead = () if lanes is None else (lanes,)
    x = _packed(rng, int(np.prod(lead + (L.n_pad,))), dev).view(
        lead + (L.k, L.q))
    active = torch.from_numpy(rng.random(lead + (L.n_pad,)) < 0.5).to(
        dev).view(lead + (L.k, L.q))
    kk = _build.DC_GATHER if lanes is None else _build.DC_GATHER_LANES
    before = dict(kk.regimes)
    got = dc_gather_cuda(x, active, *slots, **geo)
    torch.cuda.synchronize()
    assert {r: kk.regimes[r] - before[r] for r in before} == \
        {"l2": 1, "staged": 0}
    want = ref_dc_gather(x, active, *slots, **geo)
    _assert_bit_exact((got,), (want,))
    assert bool((got == 2**63 - 1).any())


@pytest.fixture(scope="module")
def half_row_layouts(wide_layouts, row_layouts):
    """``q32k2``: k = 2 partitions of the main path's q = 32,768, with slots
    enough for the 8-byte pieces; k = 2 at the largest q the 8-byte staged
    regime takes (kMaxHalvesQ = 51,648) and at the next multiple of 32 (its
    half rows would pass 232,448 B of shared memory)."""
    rng = np.random.default_rng(12)
    out = {**wide_layouts, "mt30": row_layouts["mt30"],
           "q32k2": build_layout(rmat(16, 8, seed=6, weighted=True), k=2,
                                 edge_tile=64, msg_tile=32)}
    for name, n in (("q51648", 103296), ("q51680", 103360)):
        src = np.repeat(np.arange(n), 4)
        g = from_edges(src, rng.integers(0, n, len(src)), n=n, dedup=True)
        out[name] = build_layout(g, k=2, q_mult=32, edge_tile=64,
                                 msg_tile=32)
    assert (out["q51648"].q, out["q51680"].q) == (51648, 51680)
    return out


# case: (layout, the regime its shape takes with pieces)
WIDE_DC_CASES = {"q32k": ("q32k2", "staged"), "rmat": ("rmat", "staged"),
                 "mt30": ("mt30", "staged"), "wide": ("wide", "l2"),
                 "q51648": ("q51648", "staged"), "q51680": ("q51680", "l2"),
                 "shuffled": ("rmat", "l2"), "unaligned": ("q32k2", "staged"),
                 "malformed": ("rmat", "staged")}


@pytest.mark.parametrize("lanes", [None, 3, 16])
@pytest.mark.parametrize("case", sorted(WIDE_DC_CASES))
def test_wide_dc_gather_stages_half_rows(dev, half_row_layouts, case, lanes):
    """8-byte words with the layout's pieces: two blocks a piece, each
    staging half of the rows (q % 32 == 0, q <= 51,648), bit-exact with
    the plain version with every source, half and none active; ``q32k``'s
    pieces hold sources in both halves; slot arrays off their boundaries
    take one slot a thread; pieces that do not match the tiles (and tiles
    outside [0, k)) read through L2 inside the kernel."""
    name, regime = WIDE_DC_CASES[case]
    L = half_row_layouts[name]
    rng = np.random.default_rng(65)
    kern = ScatterKernel(L, "min_with_payload", torch.int64, dev)
    if case == "q32k":   # some piece's sources lie in both halves
        off = kern.pieces.cpu().numpy() * L.msg_tile
        local = L.png_src_local
        assert any((local[a:b] < L.q // 2).any()
                   and (local[a:b] >= L.q // 2).any()
                   for a, b in zip(off[:-1], off[1:]))
    slots, pieces = _dc_slot_arrays(rng, case, L, kern, dev)
    geo = dict(k=L.k, q=L.q, msg_tile=L.msg_tile, monoid="min_with_payload")
    lead = () if lanes is None else (lanes,)
    kk = _build.DC_GATHER if lanes is None else _build.DC_GATHER_LANES
    for density in (1.0, 0.5, 0.0):
        x = _packed(rng, int(np.prod(lead + (L.n_pad,))), dev).view(
            lead + (L.k, L.q))
        active = torch.from_numpy(
            rng.random(lead + (L.n_pad,)) < density).to(dev).view(
            lead + (L.k, L.q))
        want = ref_dc_gather(x, active, *slots, **geo)
        for p in pieces:
            before = dict(kk.regimes)
            got = dc_gather_cuda(x, active, *slots, **geo, pieces=p)
            torch.cuda.synchronize()
            assert {r: kk.regimes[r] - before[r] for r in before} == \
                {"l2": int(regime == "l2"), "staged": int(regime == "staged")}
            _assert_bit_exact((got,), (want,))


def test_wide_forms_refuse_other_monoids_and_edge_functions(dev, layouts):
    """An int64 call of any monoid but min, and an edge function the kernel
    does not know or whose table type is not its own, raise before a
    launch."""
    L = layouts["rmat"]
    rng = np.random.default_rng(64)
    ns = L.n_pad + 1
    fk = FusedDCKernel(L, "min", torch.int64, dev)
    table = _packed(rng, ns, dev)
    valid = torch.ones(ns, dtype=torch.bool, device=dev)
    w = torch.ones(L.num_edges, device=dev)
    counts = {k.name: k.launches for k in _build.KERNELS}
    for monoid in ("add", "max", "or"):
        with pytest.raises(TypeError, match="min only"):
            fused_dc_cuda(table, valid, fk.edge_valid, ns, monoid, fk.tiles)
        with pytest.raises(TypeError, match="min only"):
            segment_fold_cuda(table, valid,
                              torch.zeros(ns, dtype=torch.int32, device=dev),
                              4, monoid)
    with pytest.raises(ValueError, match="edge function"):
        fused_dc_cuda(table, valid, fk.edge_valid, ns, "min", fk.tiles,
                      apply_weight=lambda v, x: v, w=w)
    with pytest.raises(TypeError, match="int64"):
        fused_dc_cuda(table.view(torch.float32)[:ns].contiguous(), valid,
                      fk.edge_valid, ns, "min", fk.tiles,
                      apply_weight=add_weight_to_key, w=w)
    with pytest.raises(TypeError, match="float32"):
        fused_dc_cuda(table, valid, fk.edge_valid, ns, "min", fk.tiles,
                      apply_weight=add_weight, w=w)
    assert counts == {k.name: k.launches for k in _build.KERNELS}


@pytest.mark.parametrize("fused", ["1", "0"])
def test_payload_apps_on_the_card_match_the_cpu(dev, monkeypatch, fused):
    """``sssp_with_parents`` (hybrid: the DC kernels and the SC fold),
    ``sssp_parents_multi`` and ``bfs_seeded_multi`` (16 lanes) on the card,
    on both DC lowerings, bit-exact with the CPU; each batched step is one
    launch of each int64 lane form of its lowering."""
    monkeypatch.setenv("REPRO_FUSED", fused)
    g = rmat(10, 8, seed=5, weighted=True)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    src = int(np.argmax(g.out_degrees()))
    _build.reset_launch_counts()
    got = rt.sssp_with_parents(L, src)
    dc_kernels = (("fused_dc",) if fused == "1"
                  else ("dc_gather", "segment_combine"))
    launched = {k.name: k.launches for k in _build.KERNELS}
    assert all(launched[name] > 0 for name in dc_kernels + ("segment_fold",))
    cpu = rt.sssp_with_parents(L, src, device="cpu")
    for key in ("dist", "parent"):
        assert np.array_equal(got[key], cpu[key]), key
    assert np.array_equal(got["dist"], rt.sssp(L, src)["dist"])
    sources = np.linspace(0, L.n - 1, 16).astype(np.int64)
    lane_kernels = ((_build.FUSED_DC_INTERLEAVE, _build.FUSED_DC_LANES)
                    if fused == "1" else
                    (_build.DC_GATHER_LANES, _build.SEGMENT_COMBINE_LANES))
    for app, keys in ((rt.sssp_parents_multi, ("dist", "parent")),
                      (rt.bfs_seeded_multi, ("level", "parent"))):
        _build.reset_launch_counts()
        res = app(L, sources)
        steps = len(res["stats"])
        assert {k.name: k.launches for k in _build.KERNELS} == \
            {k.name: steps if k in lane_kernels else 0
             for k in _build.KERNELS}
        if fused == "0":   # 8-byte rows staged in halves
            assert _build.DC_GATHER_LANES.regimes["staged"] == steps
        cpu = app(L, sources, device="cpu")
        for key in keys:
            assert np.array_equal(res[key], cpu[key]), key
    cold = rt.bfs_multi(L, sources)
    for key in ("level", "parent"):
        assert np.array_equal(res[key], cold[key]), key


def test_server_on_the_card_matches_the_cpu(dev):
    """The graph query server on the card and on the CPU over the same
    query stream: equal answers (PageRank within 1e-6) and counters."""
    from repro_torch.serve import GraphQuery, GraphQueryServer
    g = symmetrize(rmat(10, 8, seed=5, weighted=True))
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    rng = np.random.default_rng(65)
    pool = rng.choice(L.n, 6, replace=False)
    servers = {"cuda": GraphQueryServer(L),
               "cpu": GraphQueryServer(L, device="cpu")}
    done = {name: {} for name in servers}
    qid = 0
    for _ in range(3):
        batch = []
        for app, count in (("bfs", 4), ("sssp", 4), ("sssp_parents", 2)):
            for s in rng.choice(pool, count):
                batch.append((qid, app, {"source": int(s)}))
                qid += 1
        for name, srv in servers.items():
            for i, app, params in batch:
                srv.submit(GraphQuery(i, app, dict(params)))
            done[name].update({q.qid: q.result for q in srv.run()})
    for name, srv in servers.items():
        srv.submit(GraphQuery(qid, "cc", {}))
        srv.submit(GraphQuery(qid + 1, "pagerank", {"iters": 5}))
        done[name].update({q.qid: q.result for q in srv.run()})
    counters = {name: (s.cache_hits, s.cache_misses, s.semantic_hits,
                       s.semantic_misses) for name, s in servers.items()}
    assert counters["cuda"] == counters["cpu"]
    assert servers["cuda"].semantic_hits > 0
    for i, want in done["cpu"].items():
        for key, value in want.items():
            if key == "stats":
                continue
            if key == "pr":
                np.testing.assert_allclose(done["cuda"][i][key], value,
                                           rtol=0, atol=1e-6)
            else:
                assert np.array_equal(done["cuda"][i][key], value), (i, key)


def _confined_inserts(g, L, count, parts, seed, symmetric=False):
    """An insertion-only delta of ``count`` random edges (both directions
    when ``symmetric``) with both endpoints in the first ``parts``
    partitions."""
    rng = np.random.default_rng(seed)
    hi = min(parts * L.q, L.n)
    d = rt.DeltaBuffer.for_layout(L)
    u, v = rng.integers(0, hi, count), rng.integers(0, hi, count)
    w = (rng.random(count) + 0.05).astype(np.float32)
    d.insert(u, v, w)
    if symmetric:
        d.insert(v, u, w)
    return d


@pytest.mark.parametrize("fused", ["1", "0"])
def test_resume_on_the_card_is_bit_exact_with_cold(dev, monkeypatch, fused):
    """BFS (the packed seeded program), SSSP and SSSP with parents resumed
    through ``Engine.run(resume_from=, touched=)`` after an insertion-only
    delta, and CC through ``resume_labels=``, bit-exact with cold runs on
    the new layout, on each DC lowering."""
    from repro_torch.apps.bfs import bfs_seeded_pack
    monkeypatch.setenv("REPRO_FUSED", fused)
    g = rmat(10, 8, seed=5, weighted=True)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    d = _confined_inserts(g, L, 300, 2, seed=7)
    L2 = rt.apply_delta(L, d)
    src = int(np.argmax(g.out_degrees()))
    n_pad = L.n_pad
    vid = torch.arange(n_pad, dtype=torch.int32, device=dev).view(
        torch.uint32)
    dist = torch.full((n_pad,), float("inf"), device=dev)
    dist[src] = 0.0
    parent = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    parent[src] = src
    level = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    level[src] = 0
    starts = {
        "bfs_seeded": (rt.apps.bfs_seeded_program(), {
            "best": bfs_seeded_pack(level, parent.clamp(min=src)),
            "vid": vid}),
        "sssp": (rt.apps.sssp_program(), {"dist": dist}),
        "sssp_parents": (rt.apps.sssp_parents_program(), {
            "dist": dist, "parent": parent, "vid": vid})}
    frontier = np.zeros(n_pad, bool)
    frontier[src] = True
    for name, (prog, state0) in starts.items():
        old, _, _ = rt.Engine(L, prog).run(dict(state0), frontier)
        eng = rt.Engine(L2, prog)
        assert eng.fused == (fused == "1")
        warm, _, _ = eng.run(resume_from=old, touched=d)
        cold, _, _ = eng.run(dict(state0), frontier)
        for key in state0:
            assert torch.equal(warm[key].view(torch.uint8),
                               cold[key].view(torch.uint8)), (name, key)
    S = build_layout(symmetrize(g), k=8, edge_tile=64, msg_tile=32)
    ds = _confined_inserts(g, S, 300, 2, seed=8, symmetric=True)
    S2 = rt.apply_delta(S, ds)
    old = rt.connected_components(S)["label"]
    warm = rt.connected_components(S2, resume_labels=old, touched=ds)
    cold = rt.connected_components(S2)
    assert np.array_equal(warm["label"], cold["label"])
    assert len(warm["stats"]) <= len(cold["stats"])


def _scope_kernel_names(path, name):
    """The device kernel records a Chrome trace attributes to scope
    ``name``: those whose launch record (same correlation id) lies inside
    one of the scope's host ranges, or that a ``gpu_user_annotation`` of
    the scope holds."""
    import json
    events = json.loads(open(path).read())["traceEvents"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    spans = {cat: [e for e in events if e.get("name") == name
                   and e.get("cat") == cat]
             for cat in ("user_annotation", "gpu_user_annotation")}

    def inside(t, cat):
        return t is not None and any(s["ts"] <= t <= s["ts"] + s["dur"]
                                     for s in spans[cat])

    return [k["name"] for k in events if k.get("cat") == "kernel" and (
        inside(launch_ts.get(k.get("args", {}).get("correlation")),
               "user_annotation") or inside(k["ts"], "gpu_user_annotation"))]


@pytest.mark.parametrize("fused", ["1", "0"])
def test_trace_holds_kernel_scopes_and_device_records(dev, monkeypatch,
                                                      tmp_path, fused):
    """One PageRank iteration under ``obs.trace``: each ``ppm.*.cuda``
    scope of its lowering holds its kernel's device record; a run with no
    capture enters no scope."""
    from repro_torch import obs
    monkeypatch.setenv("REPRO_FUSED", fused)
    L = build_layout(rmat(10, 8, seed=5), k=8, edge_tile=64, msg_tile=32)
    eng = rt.Engine(L, rt.apps.pagerank_program(L.n), mode="dc")
    state = {"pr": torch.full((L.n_pad,), 1.0 / L.n, device=dev),
             "deg": torch.from_numpy(L.deg.astype(np.float32)).to(dev)}
    frontier = np.zeros(L.n_pad, bool)
    frontier[:L.n] = True
    eng.run(dict(state), frontier, max_iters=1, until_empty=False)
    path = tmp_path / "trace.json"
    with obs.override_enabled(True):
        with obs.trace(path):
            eng.run(dict(state), frontier, max_iters=1, until_empty=False)
            torch.cuda.synchronize()
    scopes = ({"ppm.fused_dc.cuda": "FusedEdges"} if fused == "1" else
              {"ppm.scatter.cuda": "_kernel",
               "ppm.gather.cuda": "CombineEdges"})
    for name, fragment in scopes.items():
        assert any(fragment in k for k in _scope_kernel_names(path, name)), \
            name
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    with obs.override_enabled(True):
        eng.run(dict(state), frontier, max_iters=1, until_empty=False)
    assert entered == []


# ----------------------------------------------------------------------
# the layout-free fused DC regime (csrc/fused_stream.cu) and the
# distributed engine on one NCCL rank
# ----------------------------------------------------------------------

def _stream_edges(rng, m, ne, ns, device):
    """Unsorted dst (a few outside [0, ns)), idx past the table (clamped),
    mixed validity."""
    idx = rng.integers(-3, m + 3, ne).astype(np.int32)
    dst = rng.integers(-2, ns + 2, ne).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (
        idx, rng.random(ne) < 0.8, dst))


STREAM_KERNEL_CASES = [(m, d, None) for m in MONOIDS for d in sorted(DTYPES)]
STREAM_KERNEL_CASES += [("min", "float32", add_weight),
                        ("add", "float32", add_weight)]


# both regimes of the stream fold: shared memory up to 40,960 segments,
# global atomics past it
@pytest.mark.parametrize("ns", [7, 40960, 40961, 300_001])
@pytest.mark.parametrize("monoid,dtype,fn", STREAM_KERNEL_CASES)
def test_fused_stream_kernel_matches_plain(dev, monoid, dtype, fn, ns):
    rng = np.random.default_rng(70)
    m, ne = 50_000, 200_000
    table = _payload(rng, m, DTYPES[dtype], dev)
    tvalid = torch.from_numpy(rng.random(m) < 0.6).to(dev)
    idx, evalid, dst = _stream_edges(rng, m, ne, ns, dev)
    w = _payload(rng, ne, torch.float32, dev) if fn else None
    before = _build.FUSED_STREAM.launches
    got = fused_scatter_fold(table, tvalid, idx, evalid, dst, ns,
                             monoid=monoid, apply_weight=fn, w=w)
    torch.cuda.synchronize()
    assert _build.FUSED_STREAM.launches == before + 1
    _assert_bit_exact(got, ref_fused_scatter_fold(
        M.REGISTRY[monoid](DTYPES[dtype]), table, tvalid, idx, evalid, dst,
        ns, apply_weight=fn, w=w))


# the 8-byte min: shared memory up to 22,752 segments
@pytest.mark.parametrize("ns", [7, 22752, 22753, 300_001])
@pytest.mark.parametrize("fn", [None, add_weight_to_key])
def test_wide_fused_stream_kernel_matches_plain(dev, fn, ns):
    rng = np.random.default_rng(71)
    m, ne = 50_000, 200_000
    table = _packed(rng, m, dev)
    tvalid = torch.from_numpy(rng.random(m) < 0.6).to(dev)
    idx, evalid, dst = _stream_edges(rng, m, ne, ns, dev)
    w = torch.from_numpy(rng.random(ne, dtype=np.float32)
                         * np.float32(10)).to(dev)
    got = FusedStreamKernel("min_with_payload", torch.int64)(
        table, tvalid, idx, evalid, dst, ns, w=w, apply_weight=fn)
    want = FusedStreamKernel("min_with_payload", torch.int64, plain=True)(
        table, tvalid, idx, evalid, dst, ns, w=w, apply_weight=fn)
    torch.cuda.synchronize()
    _assert_bit_exact(got, want)


def test_fused_stream_kernel_refuses_what_it_cannot_fold(dev):
    """Lanes, another edge function, a table type the edge function does
    not take, and the two edge forms at once raise before any launch."""
    rng = np.random.default_rng(72)
    table = _payload(rng, 64, torch.float32, dev)
    tvalid = torch.ones(64, dtype=torch.bool, device=dev)
    idx, evalid, dst = _stream_edges(rng, 64, 100, 9, dev)
    w = torch.ones(100, device=dev)
    before = _build.FUSED_STREAM.launches
    with pytest.raises(ValueError, match=r"\[M\] table"):
        fused_scatter_fold(table.expand(2, 64).contiguous(),
                           tvalid.expand(2, 64).contiguous(), idx, evalid,
                           dst, 9, monoid="min")
    with pytest.raises(ValueError, match="edge function"):
        fused_scatter_fold(table, tvalid, idx, evalid, dst, 9, monoid="min",
                           apply_weight=lambda v, x: v, w=w)
    with pytest.raises(TypeError, match="int64"):
        fused_scatter_fold(table, tvalid, idx, evalid, dst, 9, monoid="min",
                           apply_weight=add_weight_to_key, w=w)
    with pytest.raises(ValueError, match="tile form"):
        fused_scatter_fold(table, tvalid, None, evalid, dst, 9,
                           monoid="min")
    assert _build.FUSED_STREAM.launches == before


# the partitioned regime: one block a chunk of a destination partition,
# over PartRanges

def _parted_stream(rng, lens, q, tile, m, device):
    """A stream of destination partitions ``len(lens)`` of q destinations,
    partition j's edges one range padded to a multiple of ``tile`` (lens[j]
    real edges, 0: empty): valid edges land in their partition, the slots
    idx mostly nondecreasing within it with some past the table (clamped);
    invalid edges, a fifth of them, name the sentinel nv, another
    partition's destination or any dst.  Returns ``(idx, edge_valid, dst,
    PartRanges, nv)``."""
    parts, nv = len(lens), len(lens) * q
    idx, valid, dst, off = [], [], [], [0]
    for j, c in enumerate(lens):
        pad = -(-c // tile) * tile
        i = np.sort(rng.integers(-3, m + 3, pad))
        d = j * q + rng.integers(0, q, pad)
        v = np.zeros(pad, bool)
        v[:c] = rng.random(c) < 0.8
        stray = ~v
        d[stray] = np.where(rng.random(int(stray.sum())) < 0.5, nv,
                            rng.integers(-5, nv + 5, int(stray.sum())))
        idx.append(i), valid.append(v), dst.append(d)
        off.append(off[-1] + pad)
    cat = lambda xs, t: torch.from_numpy(np.concatenate(xs).astype(t)).to(
        device)
    parts_ = PartRanges(torch.tensor(off, dtype=torch.int64, device=device),
                        q, tile)
    return (cat(idx, np.int32), cat(valid, bool), cat(dst, np.int32), parts_,
            nv)


def _unaligned(t):
    """A copy of t whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


PARTS_KERNEL_CASES = STREAM_KERNEL_CASES + [
    ("min_with_payload", "int64", None),
    ("min_with_payload", "int64", add_weight_to_key)]


# q = 32,768: one block a four-byte partition, two an int64 one; 40,000: a
# partial last chunk; 1,000: small partitions.  An empty partition among
# them; tile 24 (not a multiple of 16) and unaligned arrays take plain loads.
@pytest.mark.parametrize("form", ["ring", "tile24", "unaligned"])
@pytest.mark.parametrize("q", [1000, 32768, 40000])
@pytest.mark.parametrize("monoid,dtype,fn", PARTS_KERNEL_CASES)
def test_fused_stream_parts_kernel_matches_plain(dev, monoid, dtype, fn, q,
                                                 form):
    rng = np.random.default_rng(73)
    m = 60_000
    tile = 24 if form == "tile24" else 256
    lens = [40_000, 0, 70_000, 5, 25_000]
    idx, evalid, dst, parts, nv = _parted_stream(rng, lens, q, tile, m, dev)
    ns, ne = nv + 1, idx.shape[0]
    wide = dtype == "int64"
    table = (_packed(rng, m, dev) if wide
             else _payload(rng, m, DTYPES[dtype], dev))
    table[-1] = M.identity_value(monoid, table.dtype)
    tvalid = torch.from_numpy(rng.random(m) < 0.6).to(dev)
    tvalid[-1] = False
    w = None
    if fn is not None:
        w = torch.from_numpy(
            rng.integers(0, 9, ne).astype(np.float32)).to(dev)
    if form == "unaligned":
        idx, evalid, dst = map(_unaligned, (idx, evalid, dst))
        w = _unaligned(w) if w is not None else None
    kern = FusedStreamKernel(monoid, table.dtype)
    before = dict(_build.FUSED_STREAM.regimes)
    got = kern(table, tvalid, idx, evalid, dst, ns, w=w, apply_weight=fn,
               parts=parts)
    torch.cuda.synchronize()
    assert _build.FUSED_STREAM.regimes["parts"] == before["parts"] + 1
    assert _build.FUSED_STREAM.regimes["stream"] == before["stream"]
    want = ref_fused_scatter_fold(M.make(monoid, table.dtype), table, tvalid,
                                  idx, evalid, dst, ns, apply_weight=fn, w=w)
    _assert_bit_exact(got, want)
    assert bool(got[1][:q].any()) and not bool(got[1][q:2 * q].any())
    # the stream regime on the same inputs
    _assert_bit_exact(kern(table, tvalid, idx, evalid, dst, ns, w=w,
                           apply_weight=fn), want)
    assert _build.FUSED_STREAM.regimes["stream"] == before["stream"] + 1


def test_fused_stream_parts_refuses_what_it_cannot_take(dev):
    """parts with the tile form, a tile that does not divide the stream,
    more partitions than segments and offsets off the card raise before
    any launch."""
    rng = np.random.default_rng(74)
    idx, evalid, dst, parts, nv = _parted_stream(rng, [300, 200], 64, 32,
                                                 500, dev)
    table = _payload(rng, 500, torch.float32, dev)
    tvalid = torch.ones(500, dtype=torch.bool, device=dev)
    before = _build.FUSED_STREAM.launches
    for bad, match in ((parts._replace(tile=48), "tile"),
                       (parts._replace(q=1000), "num_segments"),
                       (parts._replace(part_off=parts.part_off.cpu()),
                        "part_off")):
        with pytest.raises((ValueError, TypeError), match=match):
            fused_scatter_fold(table, tvalid, idx, evalid, dst, nv + 1,
                               monoid="min", parts=bad)
    with pytest.raises(ValueError, match="tile form"):
        fused_scatter_fold(table, tvalid, None, evalid, None, nv + 1,
                           monoid="min", parts=parts,
                           tiles=EdgeTiles(idx, dst, idx, parts.part_off, 64,
                                           32))
    assert _build.FUSED_STREAM.launches == before


@pytest.fixture
def nccl_mesh(dev, tmp_path):
    """One NCCL rank on the card (world size 1, a file store)."""
    import datetime

    import torch.distributed as dist
    from repro_torch.dist import make_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh("cuda")
    finally:
        dist.destroy_process_group()


def test_dist_engine_on_one_nccl_rank_matches_engine(dev, nccl_mesh):
    """BFS (every mode), SSSP with parents (the int64 layout-free regime)
    and a 4-lane ``bfs_multi`` through ``DistEngine`` on one NCCL rank,
    bit-exact with the single-device engine; one SC step's dense and
    ragged forms equal."""
    from repro_torch.apps import bfs_program, sssp_parents_program
    from repro_torch.dist.engine import DistEngine, build_sc_step
    from repro_torch.graph.shard import shard_layout
    g = rmat(12, 8, seed=9, weighted=True)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    SL = shard_layout(L, 1)
    src = int(np.argmax(g.out_degrees()))
    want = rt.bfs(L, src)
    for mode in ("dc", "sc", "hybrid", "hybrid_pp"):
        before = dict(_build.FUSED_STREAM.regimes)
        got = rt.bfs(L, src, engine=DistEngine(SL, bfs_program(), nccl_mesh,
                                               mode=mode))
        assert np.array_equal(got["parent"], want["parent"]), mode
        assert np.array_equal(got["level"], want["level"]), mode
        # the engine's fused gather takes the partitioned regime only
        assert _build.FUSED_STREAM.regimes["stream"] == before["stream"]
        if mode == "dc":
            assert _build.FUSED_STREAM.regimes["parts"] > before["parts"]
    got = rt.sssp_with_parents(L, src, engine=DistEngine(
        SL, sssp_parents_program(), nccl_mesh, mode="dc"))
    want = rt.sssp_with_parents(L, src)
    for key in ("dist", "parent"):
        assert np.array_equal(got[key], want[key]), key
    sources = [src, 1, 2, 3]
    got = rt.bfs_multi(L, sources, engine=DistEngine(SL, bfs_program(),
                                                     nccl_mesh, mode="dc"))
    want = rt.bfs_multi(L, sources)
    for key in ("parent", "level"):
        assert np.array_equal(got[key], want[key]), key
    eng = DistEngine(SL, bfs_program(), nccl_mesh, mode="sc")
    state = {"parent": torch.full((L.n_pad,), -1, dtype=torch.int32,
                                  device=dev),
             "level": torch.zeros(L.n_pad, dtype=torch.int32, device=dev),
             "vid": torch.arange(L.n_pad, dtype=torch.int32,
                                 device=dev).view(torch.uint32)}
    active = torch.rand(L.n_pad, device=dev) < 0.3
    out = [build_sc_step(eng.program, eng.meta, nccl_mesh, ragged=r)(
        state, active, eng.arrays, 0) for r in (False, True)]
    torch.cuda.synchronize()
    assert torch.equal(out[0][1], out[1][1])
    for key in state:
        assert torch.equal(out[0][0][key], out[1][0][key]), key


# ----------------------------------------------------------------------
# the LM stack and the baselines: plain PyTorch on the card, held against
# the same code on the CPU (f32 with TF32 off: 1e-4, the CPU tests'
# tolerance against the reference)
# ----------------------------------------------------------------------

@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _lm_pair(arch, dev):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    cfg = get_smoke_config(arch)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(1))
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-780m", "yi-34b",
                                  "mistral-nemo-12b", "qwen2-0.5b", "yi-6b",
                                  "llama4-scout-17b-a16e", "mixtral-8x7b",
                                  "pixtral-12b", "hubert-xlarge"])
def test_smoke_lm_on_the_card_matches_the_cpu(dev, no_tf32, arch):
    """Each smoke config's forward, and prefill then decode where it
    decodes, on the card against the CPU on the same weights."""
    from repro_torch.serve import decode_step, init_cache, prefill
    cfg, cpu, card = _lm_pair(arch, dev)
    rng = np.random.default_rng(0)
    S = 12
    if cfg.frontend is not None:
        e = torch.from_numpy(rng.normal(size=(2, S, cfg.d_model))
                             .astype(np.float32))
        inputs = {"embeds": e}
    else:
        inputs = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, S))).long()}
    def on(d):
        return {k: v.to(d) for k, v in inputs.items()}

    with torch.no_grad():
        want = cpu(on("cpu").get("tokens"), embeds=on("cpu").get("embeds"))
        got = card(on(dev).get("tokens"), embeds=on(dev).get("embeds"))
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-4)
        if not cfg.decoder:
            return
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 3))).long()
        outs = []
        for model, d in ((cpu, "cpu"), (card, dev)):
            cache = init_cache(cfg, 2, 32, dtype=torch.float32, device=d)
            lg, cache = prefill(model, on(d), cache)
            seq = [lg.cpu()]
            for i in range(3):
                lg, cache = decode_step(model, toks[:, i].to(d), cache)
                seq.append(lg.cpu())
            outs.append(torch.stack(seq))
        np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=0,
                                   atol=1e-4)


def test_lm_server_on_the_card_matches_the_cpu(dev, no_tf32):
    from repro_torch.serve import Request, Server
    cfg, cpu, card = _lm_pair("qwen2-0.5b", dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 16))
               for _ in range(5)]
    done = []
    for model in (cpu, card):
        srv = Server(model, n_slots=2, max_len=48, dtype=torch.float32)
        for r, p in enumerate(prompts):
            srv.submit(Request(rid=r, prompt=p, max_new=6))
        done.append({d.rid: d.out for d in srv.run()})
    assert done[1] == done[0]


def test_baselines_on_the_card_match_the_cpu(dev):
    from repro_torch.baselines import vc
    g = rmat(12, 8, seed=3, weighted=True)
    gs = symmetrize(g)
    src = int(np.argmax(g.out_degrees()))
    for fn in ("bfs_push", "bfs_pull", "bfs_ec"):
        assert np.array_equal(getattr(vc, fn)(g, src),
                              getattr(vc, fn)(g, src, device="cpu")), fn
    assert np.array_equal(vc.sssp_push(g, src),
                          vc.sssp_push(g, src, device="cpu"))
    assert np.array_equal(vc.cc_ec(gs), vc.cc_ec(gs, device="cpu"))
    np.testing.assert_allclose(vc.pagerank_spmv(g),
                               vc.pagerank_spmv(g, device="cpu"), rtol=0,
                               atol=1e-6)

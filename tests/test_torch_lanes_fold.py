"""The host side of two kernel forms, on the CPU against the plain versions
and ``repro``'s reference.

``fused_dc``'s lane form (``csrc/fused_dc.cu``: ``fused_dc_interleave`` and
``fused_dc_lanes``) reads a destination-sorted copy of a layout's edges
(:func:`build_lane_edges`), the tables interleaved by lane with a validity
bit mask a vertex (:func:`ref_interleave_lanes`, the interleaving kernel's
plain version), and folds :func:`lane_group` lanes of :func:`lane_width`
destinations a block.  ``dc_gather``'s 8-byte staged regime
(``csrc/dc_gather.cu``, ``halves_kernel``) takes each piece of
:func:`dc_pieces` with two blocks, each staging half of the source rows and
writing the slots whose source lies in its half.  The kernels run only on a
card (``tests/test_torch_cuda.py``); here the copy, the interleaving, the
choice of group and width and the pieces are held to their contracts, and
NumPy models of the two kernels' block decompositions, built on them, are
held bit-exact against the plain versions and the reference on integer
payloads (exact in any order) and packed ``min_with_payload`` words.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # kernel_harness imports it
from kernel_harness import payload

from repro.apps import sssp_parents as ref_sp
from repro.core import monoid as RM
from repro.graph import build_layout, rmat
from repro.kernels import ops as ref_ops
from repro_torch.apps import bfs_program, sssp_program
from repro_torch.core import monoid as M
from repro_torch.core.engine import Engine
from repro_torch.interop import layout_from_reference, packed_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.dc_gather import (dc_pieces, identity_bits,
                                           ref_dc_gather)
from repro_torch.kernels.fold_block import segment_fold
from repro_torch.kernels.fused_step import (LANE_FINE, LANE_MAX_GROUP,
                                            LANE_SMEM, add_weight,
                                            add_weight_to_key,
                                            build_lane_edges, global_edges,
                                            lane_group, lane_width,
                                            ref_fused_scatter_fold,
                                            ref_interleave_lanes)
from torch_reference_shims import same_bits, x64  # noqa: F401

torch.set_num_threads(1)

SMS = 132
MONOIDS = ("add", "min", "max")
DTYPES = ("float32", "int32", "uint32")
INT64_MAX = np.uint64(2**63 - 1)
UINT64_MAX = np.uint64(2**64 - 1)


@pytest.fixture(scope="module")
def layouts():
    """RMAT scale 10 in k = 4 partitions of q = 256 (weighted), and the
    serving tests' scale 8 in k = 8 of q = 32."""
    out = {}
    for name, (scale, k) in {"q256": (10, 4), "q32": (8, 8)}.items():
        L = build_layout(rmat(scale, 8, seed=3, weighted=True), k=k,
                         edge_tile=64, msg_tile=32)
        out[name] = (L, layout_from_reference(L))
    return out


def _packed(rng, n):
    """Packed words (random non-negative f32 keys, a tenth +inf, any uint32
    payload) as the reference's uint64."""
    keys = rng.random(n, dtype=np.float32) * np.float32(100)
    keys[rng.random(n) < 0.1] = np.inf
    pay = rng.integers(0, 2**32, n, dtype=np.uint64)
    return (keys.view(np.uint32).astype(np.uint64) << np.uint64(32)) | pay


def _as_reference(words):
    u = packed_to_numpy(words)
    return np.where(u == INT64_MAX, UINT64_MAX, u)


# ---- fused_dc's lane form ----

def test_lane_group_and_width_for_live_widths():
    """G for the widths ``_compact_lane_index`` gives (powers of two) and
    any other batch: the largest power of two dividing W, at most 16; the
    width a multiple of the copy's fine, its rows within LANE_SMEM, as wide
    as that allows and no wider than q needs."""
    assert [lane_group(w) for w in (1, 2, 4, 16)] == [1, 2, 4, 16]
    assert [lane_group(w) for w in (3, 12, 32, 40, 64)] == [1, 4, 16, 8, 16]
    for group in (1, 2, 4, 8, LANE_MAX_GROUP):
        for itemsize in (4, 8):
            width = lane_width(group, itemsize, 32768)
            rows = group * ((width + 1) * itemsize + width + 4)
            wider = group * ((width + LANE_FINE + 1) * itemsize
                             + width + LANE_FINE + 4)
            assert width % LANE_FINE == 0 and width >= LANE_FINE
            assert rows <= LANE_SMEM and (wider > LANE_SMEM
                                          or width == 32768)
    # the main path's shapes: 16 four-byte lanes over 1408 destinations a
    # block, 16 eight-byte ones over 768; one lane over 22,656
    assert lane_width(16, 4, 32768) == 1408
    assert lane_width(16, 8, 32768) == 768
    assert lane_width(1, 4, 32768) == 22656
    assert lane_width(16, 4, 100) == LANE_FINE
    assert lane_width(1, 4, 256) == 256


@pytest.mark.parametrize("fine", [LANE_FINE, 16, 7])
@pytest.mark.parametrize("name", ["q256", "q32"])
def test_lane_edges_hold_each_valid_edge_once_in_its_slice(layouts, name,
                                                           fine):
    """Every valid gather-order edge exactly once, with its source's row,
    local destination and weight; each partition's edges sorted by
    destination, a destination's edges in gather order; each fine slice's
    offsets bracket exactly its destinations' edges; the rows rank the
    table's entries by the edges they source, most first, ties by
    index."""
    L, TL = layouts[name]
    kern = ops.FusedDCKernel(TL, "min", torch.float32, "cpu",
                             apply_weight=add_weight)
    le = build_lane_edges(kern.tiles, kern.edge_valid, kern.edge_w, fine)
    assert le.edge_valid is kern.edge_valid and le.w_from is kern.edge_w
    valid = np.flatnonzero(L.edge_valid)
    src = (np.repeat(L.tile_src_part.astype(np.int64), L.edge_tile) * L.q
           + L.edge_src_local)[valid]
    part = np.repeat(L.tile_dst_part.astype(np.int64), L.edge_tile)[valid]
    local = L.edge_dst_local[valid]
    order = np.lexsort((np.arange(len(valid)), local, part))
    assert le.src.dtype == le.dst.dtype == le.rank.dtype == torch.int32
    uses = np.bincount(src, minlength=L.n_pad + 1)
    by_use = np.lexsort((np.arange(L.n_pad + 1), -uses))
    assert L.n_pad == L.k * L.q
    assert np.array_equal(le.rank.numpy()[by_use], np.arange(L.n_pad + 1))
    assert np.array_equal(le.src.numpy(), le.rank.numpy()[src[order]])
    assert np.array_equal(le.dst.numpy(), local[order])
    assert np.array_equal(le.w.numpy(), L.edge_w[valid][order])
    n_fine = -(-L.q // fine)
    off = le.off.numpy()
    assert off.shape == (L.k * n_fine + 1,) and off[0] == 0
    assert off[-1] == len(valid) and np.all(np.diff(off) >= 0)
    slot = np.repeat(np.arange(L.k * n_fine), np.diff(off))
    assert np.array_equal(slot, part[order] * n_fine + local[order] // fine)
    assert le.nbytes() == len(valid) * 12 + off.nbytes + (L.n_pad + 1) * 4


def test_lane_edges_drop_invalid_and_out_of_range_edges(layouts):
    """Edges marked invalid, and valid ones whose local destination lies
    outside [0, q) (which fold nothing), are not in the copy; without
    weights it holds none."""
    L, TL = layouts["q256"]
    kern = ops.FusedDCKernel(TL, "add", torch.float32, "cpu")
    rng = np.random.default_rng(4)
    ev = kern.edge_valid & torch.from_numpy(rng.random(L.num_edges) < 0.7)
    dst_local = kern.edge_dst_local.clone()
    bad = torch.from_numpy(rng.random(L.num_edges) < 0.05)
    dst_local[bad] = torch.from_numpy(
        rng.choice([-1, L.q, L.q + 9], int(bad.sum())).astype(np.int32))
    tiles = kern.tiles._replace(edge_dst_local=dst_local)
    le = build_lane_edges(tiles, ev)
    assert le.w is None and le.w_from is None
    assert le.src.numel() == int((ev & ~bad).sum())
    assert bool(((le.dst >= 0) & (le.dst < L.q)).all())


def test_kernels_on_one_layout_share_one_lane_copy(layouts):
    """Every ``FusedDCKernel`` bound to a layout on a device (every
    engine's) reads the layout's one ``LaneCopy``: its validity, its
    weights, an edge copy built at the first lane call and, at the first
    weighted one, its weights beside the same arrays; both equal to
    ``build_lane_edges``' own.  Another layout, or this one with its
    validity array replaced, gets a copy of its own; a copy goes with its
    layout."""
    L, _ = layouts["q256"]
    TL, other = layout_from_reference(L), layout_from_reference(L)
    bfs = ops.FusedDCKernel(TL, "min", torch.float32, "cpu")
    sssp = ops.FusedDCKernel(TL, "min", torch.float32, "cpu",
                             apply_weight=add_weight)
    copy = bfs.lane_copy
    assert sssp.lane_copy is copy and ops.lane_copy(TL, "cpu") is copy
    assert bfs.edge_valid is sssp.edge_valid is copy.edge_valid
    assert sssp.edge_w is copy.edge_w and copy.nbytes() == 0
    engines = [Engine(TL, prog(), mode="dc", device="cpu")
               for prog in (bfs_program, sssp_program)]
    assert all(e._fused.lane_copy is copy for e in engines)

    plain = bfs.lane_edges()
    weighted = sssp.lane_edges()
    assert bfs.lane_edges() is plain and sssp.lane_edges() is weighted
    assert plain.w is None and weighted.w_from is copy.edge_w
    for name in ("src", "dst", "off", "rank"):
        assert getattr(weighted, name) is getattr(plain, name)
    want = build_lane_edges(bfs.tiles, copy.edge_valid, copy.edge_w)
    for name in ("src", "dst", "off", "rank", "w"):
        assert torch.equal(getattr(weighted, name), getattr(want, name))
    assert copy.nbytes() == want.nbytes() and copy.build_s > 0

    assert ops.FusedDCKernel(other, "min", torch.float32,
                             "cpu").lane_copy is not copy
    TL.edge_valid = TL.edge_valid.copy()
    fresh = ops.lane_copy(TL, "cpu")
    assert fresh is not copy and fresh.edges is None
    assert ops.FusedDCKernel(TL, "add", torch.float32,
                             "cpu").lane_copy is fresh
    key = (id(TL), "cpu", None)
    assert ops._LANE_COPIES[key] is fresh
    del TL, engines, bfs, sssp, copy, fresh
    gc.collect()
    assert key not in ops._LANE_COPIES


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("lanes", [1, 3, 16, 40])
@pytest.mark.parametrize("dtype", ["float32", "uint32", "int64"])
def test_interleave_matches_a_numpy_transpose(lanes, dtype, ranked):
    """``ref_interleave_lanes``: the ``[M, B]`` table bit for bit, and bit
    ``b % 32`` of word ``b // 32`` of a row's mask its lane ``b``'s
    validity (W = 40: two words); with a rank, entry v at row rank[v]."""
    rng = np.random.default_rng(lanes)
    m = 77
    bits = rng.integers(-2**31, 2**31, (lanes, m)).astype(
        np.int64 if dtype == "int64" else np.int32)
    table = M.from_bits(torch.from_numpy(bits), getattr(torch, dtype))
    valid = rng.random((lanes, m)) < 0.5
    rank = rng.permutation(m) if ranked else np.arange(m)
    il, mask = ref_interleave_lanes(
        table, torch.from_numpy(valid),
        torch.from_numpy(rank.astype(np.int32)) if ranked else None)
    assert il.dtype == table.dtype and mask.dtype == torch.int32
    assert il.stride() == (lanes, 1) and mask.is_contiguous()
    inv = np.argsort(rank)          # the entry at each row
    assert np.array_equal(M.as_bits(il).numpy(), bits.T[inv])
    valid = valid[:, inv]
    words = mask.numpy().view(np.uint32)
    assert words.shape == (m, -(-lanes // 32))
    for b in range(lanes):
        assert np.array_equal((words[:, b // 32] >> (b % 32)) & 1,
                              valid[b].astype(np.uint32))
    spare = 32 * words.shape[1] - lanes      # the last word's unused bits
    if spare:
        assert not (words[:, -1] >> np.uint32(32 - spare)).any()


def _lane_fold_model(le, table, table_valid, *, k, q, monoid, fn=None):
    """The lane kernel's blocks in NumPy: for each lane group and each
    (partition, sub-slice) block, fold the copy's edges between the block's
    offsets, each a destination inside the block, into that block's
    accumulators, from the interleaved table and its masks.  Returns (acc,
    touched) over ``[B, k*q + 1]``."""
    lanes, m = table.shape
    il, mask = ref_interleave_lanes(table, table_valid, le.rank)
    bits = M.as_bits(il).numpy()
    words = mask.numpy().view(np.uint32)
    group = lane_group(lanes)
    width = lane_width(group, table.element_size(), q, le.fine)
    n_fine, off = -(-q // le.fine), le.off.numpy()
    src = np.clip(le.src.numpy().astype(np.int64), 0, m - 1)
    dst = le.dst.numpy()
    ident = M.identity_value(monoid, table.dtype)
    out = M.full((lanes, k * q + 1), ident, table.dtype, "cpu")
    touched = torch.zeros((lanes, k * q + 1), dtype=torch.bool)
    seen = np.zeros(len(src), dtype=np.int64)
    for g in range(lanes // group):
        for p in range(k):
            for lo in range(0, q, width):
                f0 = lo // le.fine
                f1 = min(f0 + width // le.fine, n_fine)
                e = np.arange(off[p * n_fine + f0], off[p * n_fine + f1])
                assert np.all((dst[e] >= lo) & (dst[e] < lo + width))
                seen[e] += 1
                for lane in range(g * group, (g + 1) * group):
                    ok = (words[src[e], lane // 32] >> (lane % 32)) & 1 == 1
                    ee = e[ok]
                    vals = M.from_bits(torch.from_numpy(
                        bits[src[ee], lane].copy()), table.dtype)
                    if fn is not None:
                        vals = fn(vals, le.w[torch.from_numpy(ee)]).to(
                            table.dtype)
                    seg = torch.from_numpy(p * q + dst[ee].astype(np.int64))
                    a, t = segment_fold(vals, torch.ones(len(ee),
                                                         dtype=torch.bool),
                                        seg, k * q + 1, monoid)
                    out[lane] = M.where(t, a, out[lane])
                    touched[lane] |= t
    assert np.all(seen == lanes // group)   # each group reads each edge once
    return out, touched


@pytest.mark.parametrize("lanes", [1, 2, 4, 16])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("monoid", MONOIDS)
def test_lane_fold_model_matches_plain_and_reference(layouts, monoid, dtype,
                                                     lanes):
    """The model of the lane kernel over the copy equals the plain lane
    version (``FusedDCKernel`` on the CPU) and ``jax.vmap`` of the
    reference's ``RefFusedDC``; lane 0 has no valid source."""
    L, TL = layouts["q256"]
    rng = np.random.default_rng(lanes + 7)
    ns = L.n_pad + 1
    table = jnp.stack([payload(rng, ns, dtype) for _ in range(lanes)])
    valid = rng.random((lanes, ns)) < 0.5
    valid[0] = False
    kern = ops.FusedDCKernel(TL, monoid, getattr(torch, dtype), "cpu")
    t_table = torch.from_numpy(np.array(table))
    t_valid = torch.from_numpy(valid)
    got = _lane_fold_model(build_lane_edges(kern.tiles, kern.edge_valid),
                           t_table, t_valid, k=L.k, q=L.q, monoid=monoid)
    plain = kern(t_table, t_valid)
    oracle = ref_ops.RefFusedDC(L, RM.REGISTRY[monoid](jnp.dtype(dtype)))
    want = jax.vmap(oracle)(table, jnp.asarray(valid))
    for g, p, w in zip(got, plain, want):
        same_bits(g.numpy(), p.numpy())
        same_bits(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("weighted", [False, True])
def test_lane_fold_model_int64_matches_reference(x64, layouts, weighted):
    """Packed ``min_with_payload`` words over 4 lanes, with
    ``add_weight_to_key`` (the copy's weights) or none: the model, the
    plain lane version and the reference's ``RefFusedDC`` lane by lane."""
    L, TL = layouts["q256"]
    rng = np.random.default_rng(9)
    ns, lanes = L.n_pad + 1, 4
    words = np.stack([_packed(rng, ns) for _ in range(lanes)])
    valid = rng.random((lanes, ns)) < 0.5
    fn = add_weight_to_key if weighted else None
    kern = ops.FusedDCKernel(TL, "min_with_payload", torch.int64, "cpu",
                             apply_weight=fn)
    table = torch.from_numpy(words.view(np.int64))
    le = build_lane_edges(kern.tiles, kern.edge_valid,
                          kern.edge_w if weighted else None)
    got = _lane_fold_model(le, table, torch.from_numpy(valid), k=L.k, q=L.q,
                           monoid="min_with_payload", fn=fn)
    plain = kern(table, torch.from_numpy(valid))
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    with jax.experimental.enable_x64():
        oracle = ref_ops.RefFusedDC(L, RM.min_with_payload())
        if weighted:
            oracle.apply_weight = ref_sp.sssp_parents_program().apply_weight
        for b in range(lanes):
            want = [np.asarray(a) for a in oracle(jnp.asarray(words[b]),
                                                  jnp.asarray(valid[b]))]
            same_bits(_as_reference(got[0][b]), want[0])
            same_bits(got[1][b].numpy(), want[1])


def test_lane_fold_model_add_weight_matches_plain(layouts):
    """SSSP's step (f32 min plus the edge's weight) over 16 lanes."""
    L, TL = layouts["q32"]
    rng = np.random.default_rng(12)
    ns, lanes = L.n_pad + 1, 16
    kern = ops.FusedDCKernel(TL, "min", torch.float32, "cpu",
                             apply_weight=add_weight)
    table = torch.from_numpy(np.stack(
        [np.asarray(payload(rng, ns, "float32")) for _ in range(lanes)]))
    valid = torch.from_numpy(rng.random((lanes, ns)) < 0.6)
    le = build_lane_edges(kern.tiles, kern.edge_valid, kern.edge_w)
    got = _lane_fold_model(le, table, valid, k=L.k, q=L.q, monoid="min",
                           fn=add_weight)
    idx, dst = global_edges(kern.tile_src_part, kern.tile_dst_part,
                            kern.edge_src_local, kern.edge_dst_local,
                            kern.edge_valid, q=L.q, edge_tile=L.edge_tile,
                            n_pad=L.n_pad)
    want = ref_fused_scatter_fold(M.make("min", torch.float32), table, valid,
                                  idx, kern.edge_valid, dst, ns,
                                  apply_weight=add_weight, w=kern.edge_w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- dc_gather's 8-byte staged regime ----

def _halves_model(x, active, local, valid, tile_part, pieces, *, k, q,
                  msg_tile, ident):
    """``halves_kernel`` in NumPy: two blocks a piece, block h staging half
    h of the piece's partition's rows and writing the slots whose source
    lies there (block 0 also those outside [0, q), with the identity); a
    piece whose tiles do not all name its partition (or a partition outside
    [0, k)) read through L2, split between its blocks.  Returns the bins
    and how many blocks wrote each slot."""
    half = q // 2
    bins = np.zeros(len(local), dtype=x.dtype)
    writes = np.zeros(len(local), dtype=np.int64)
    for t0, t1 in zip(pieces[:-1], pieces[1:]):
        part = int(tile_part[t0])
        staged = 0 <= part < k and np.all(tile_part[t0:t1] == part)
        s = np.arange(t0 * msg_tile, t1 * msg_tile)
        for h in (0, 1):
            if not staged:   # the L2 loop: block h takes every other slot
                mine = s[(s - s[0]) % 2 == h] if len(s) else s
                p = np.repeat(tile_part[t0:t1], msg_tile)[mine - s[0]]
                inside = (local[mine] >= 0) & (local[mine] < q) \
                    & (p >= 0) & (p < k)
                src = np.where(inside, p * q + local[mine], 0)
                ok = valid[mine] & inside & active.reshape(-1)[src]
                bins[mine] = np.where(ok, x.reshape(-1)[src], ident)
                writes[mine] += 1
                continue
            rows_x = x[part, h * half:(h + 1) * half]
            rows_a = active[part, h * half:(h + 1) * half]
            loc = local[s]
            inside = (loc >= 0) & (loc < q)
            i = loc - h * half
            mine = np.where(inside, (i >= 0) & (i < half), h == 0)
            j = np.where(mine & inside, i, 0)
            v = np.where(valid[s] & inside & rows_a[j], rows_x[j], ident)
            bins[s[mine]] = v[mine]
            writes[s[mine]] += 1
    return bins, writes


def _bad_slots(L, rng):
    """The layout's slot arrays with sources outside [0, q) and three tiles
    outside [0, k)."""
    local = L.png_src_local.copy()
    bad = rng.random(len(local)) < 0.05
    local[bad] = rng.choice([-1, -L.q, L.q, L.q + 7], int(bad.sum()))
    tp = L.png_tile_part.copy()
    tp[rng.choice(len(tp), 3, replace=False)] = [-1, L.k, L.k + 5]
    return local, tp


@pytest.mark.parametrize("blocks", [SMS, 7])
@pytest.mark.parametrize("case", ["layout", "malformed"])
@pytest.mark.parametrize("name", ["q256", "q32"])
def test_halves_model_writes_each_slot_once_as_the_reference(
        x64, layouts, name, case, blocks):
    """The 8-byte pieces (``dc_pieces(value_bytes=8)``) under the model of
    ``halves_kernel``: every slot written by exactly one block, pieces whose
    sources straddle the half included, and the bins equal to the plain
    version and to the reference's ``RefScatter`` on packed words; with
    malformed sources and tiles, the pieces of the bad tiles and the
    layout's own (which the kernel reads through L2)."""
    L, TL = layouts[name]
    rng = np.random.default_rng(blocks)
    local, tp = L.png_src_local, L.png_tile_part
    if case == "malformed":
        local, tp = _bad_slots(L, rng)
    off = dc_pieces(tp, q=L.q, msg_tile=L.msg_tile, blocks=blocks,
                    value_bytes=8)
    assert off is not None
    pieces = [off, dc_pieces(L.png_tile_part, q=L.q, msg_tile=L.msg_tile,
                             blocks=blocks, value_bytes=8)]
    words = _packed(rng, L.n_pad)
    active = rng.random(L.n_pad) < 0.5
    valid = L.png_src < L.n_pad
    x = words.view(np.int64).reshape(L.k, L.q)
    ident = np.int64(identity_bits("min_with_payload", torch.int64))
    want = ref_dc_gather(torch.from_numpy(x),
                         torch.from_numpy(active.reshape(L.k, L.q)),
                         torch.from_numpy(local), torch.from_numpy(valid),
                         torch.from_numpy(tp), k=L.k, q=L.q,
                         msg_tile=L.msg_tile, monoid="min_with_payload")
    starts = off[:-1] * L.msg_tile
    ends = off[1:] * L.msg_tile
    assert any(((local[a:b] >= 0) & (local[a:b] < L.q // 2)).any()
               and ((local[a:b] >= L.q // 2) & (local[a:b] < L.q)).any()
               for a, b in zip(starts, ends))
    for p in pieces:
        bins, writes = _halves_model(
            x, active.reshape(L.k, L.q), local, valid, tp, p, k=L.k, q=L.q,
            msg_tile=L.msg_tile, ident=ident)
        assert np.all(writes == 1)
        assert np.array_equal(bins, want.numpy())
    if case == "layout":
        with jax.experimental.enable_x64():
            ref = np.asarray(ref_ops.RefScatter(L, RM.min_with_payload())(
                jnp.asarray(words), jnp.asarray(active)))
        same_bits(_as_reference(want), ref)


def test_eight_byte_pieces_weigh_slots_and_rows_by_width():
    """``dc_pieces``' choice for 8-byte words: a mean run's 13-byte slots
    against a 9-byte-a-vertex row (4-byte: 9 against 5)."""
    q, msg_tile, k = 900, 10, 4
    for value_bytes, ratio in ((4, 5 / 9), (8, 9 / 13)):
        for spv, staged in ((ratio - 0.02, False), (ratio + 0.01, True)):
            tiles = int(round(spv * q / msg_tile))
            tp = np.repeat(np.arange(k), tiles).astype(np.int32)
            off = dc_pieces(tp, q=q, msg_tile=msg_tile, blocks=SMS,
                            value_bytes=value_bytes)
            assert (off is not None) == staged, (value_bytes, spv)

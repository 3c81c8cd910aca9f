"""The destination-partition ranges of the distributed engine's received
edges (``repro_torch.kernels.fused_step.part_ranges``), which select the
partitioned regime of the layout-free fused kernel (``csrc/fused_stream.cu``),
on the CPU.

  * Each rank's derived ``part_off`` equals the offsets the layout's own
    ``blk_off`` gives its destination partitions, at D = 1, 2 and 4; where
    the derived tile is a multiple of the layout's edge tile, the last range
    ends in the rank's tail padding and covers only invalid edges.
  * A slice with one valid edge moved into another partition's range, or
    past the ranges, makes ``part_ranges`` and ``DistEngine``'s set-up
    raise; under ``REPRO_FUSED=0`` the set-up derives nothing.
  * ``FusedStreamKernel`` with and without ``parts`` gives the same output,
    and the reference's ``FusedStreamKernel`` (Pallas, interpret mode) and
    its oracle give it too, on a rank's received bins, for every monoid,
    dtype and edge function of ``test_torch_dist.py``'s stream cases, and
    for the 8-byte min against the reference's oracle.
"""
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import monoid as RM
from repro.kernels import fused_step as ref_fused_step
from repro.kernels import ops as ref_ops
from repro_torch.apps import bfs_program, sssp_program
from repro_torch.core import monoid as TM
from repro_torch.dist import engine as port_dist
from repro_torch.dist import make_mesh
from repro_torch.graph import build_layout, rmat
from repro_torch.graph.shard import shard_layout
from repro_torch.interop import packed_to_numpy
from repro_torch.kernels.fused_step import (PARTS_MAX_TILE, PartRanges,
                                            add_weight, add_weight_to_key,
                                            part_ranges)
from repro_torch.kernels.ops import FusedStreamKernel

torch.set_num_threads(1)

RANKS = (1, 2, 4)
# (scale, k, edge_tile, weighted): RMAT layouts with several partitions a
# rank at D = 4
LAYOUTS = [(9, 8, 64, True), (10, 16, 16, False), (11, 32, 32, True)]


def _layout(scale, k, edge_tile, weighted):
    return build_layout(rmat(scale, 8, seed=1, weighted=weighted), k=k,
                        edge_tile=edge_tile, msg_tile=8)


def _blk_ranges(L, kpd, d):
    """Rank d's destination-partition offsets from the layout's blk_off."""
    base = L.blk_off[d * kpd * L.k]
    return np.array([L.blk_off[(d * kpd + j) * L.k] - base
                     for j in range(kpd + 1)], dtype=np.int64)


def _derive(SL, d):
    return part_ranges(torch.from_numpy(SL.in_dst_local[d]),
                       torch.from_numpy(SL.in_valid[d]), SL.q, SL.kpd)


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("shape", LAYOUTS)
def test_part_ranges_equal_layout_blocks(shape, D):
    L = _layout(*shape)
    SL = shard_layout(L, D)
    for d in range(D):
        pr = _derive(SL, d)
        assert isinstance(pr, PartRanges)
        assert (pr.q, pr.tile) == (SL.q, L.edge_tile), d
        assert pr.part_off.dtype == torch.int64
        np.testing.assert_array_equal(pr.part_off.numpy(),
                                      _blk_ranges(L, SL.kpd, d), f"rank {d}")


def test_part_ranges_end_in_tail_padding_past_a_wider_tile():
    """One partition a rank (k = 4, D = 4): the gcd of the starts can be a
    multiple of the edge tile, and the last range then ends at its next
    multiple, inside the rank's tail padding, past blk_off's end."""
    L = _layout(8, 4, 8, True)
    SL = shard_layout(L, 4)
    wider = 0
    for d in range(4):
        pr = _derive(SL, d)
        want = _blk_ranges(L, SL.kpd, d)
        got = pr.part_off.numpy()
        np.testing.assert_array_equal(got[:-1], want[:-1])
        assert pr.tile % L.edge_tile == 0 and pr.tile <= PARTS_MAX_TILE
        assert want[-1] <= got[-1] <= SL.ne_d and got[-1] % pr.tile == 0
        assert not SL.in_valid[d, want[-1]:].any()
        wider += got[-1] != want[-1]
    assert wider, "no rank's tile was wider than the edge tile"


def test_part_ranges_tile_is_capped():
    """A stream whose starts share a factor past PARTS_MAX_TILE takes the
    largest divisor within it."""
    q, ne = 4, 4096
    dst = torch.full((ne,), 8, dtype=torch.int32)
    valid = torch.zeros(ne, dtype=torch.bool)
    dst[:10], valid[:10] = 1, True
    dst[2048:2050], valid[2048:2050] = 5, True
    pr = part_ranges(dst, valid, q, 2)
    assert pr.tile == 1024
    assert pr.part_off.tolist() == [0, 2048, 3072]


def _moved(SL, d, src_part, dst_part):
    """Rank d's in_dst_local and in_valid with the first valid edge of
    partition src_part moved onto the last invalid slot of partition
    dst_part's range (block padding), the old slot invalidated."""
    dstl, valid = SL.in_dst_local[d].copy(), SL.in_valid[d].copy()
    part_off = _derive(SL, d).part_off.numpy()
    e = np.flatnonzero(valid & (dstl // SL.q == src_part))[0]
    lo, hi = part_off[dst_part], part_off[dst_part + 1]
    holes = np.flatnonzero(~valid[lo:hi]) + lo
    assert holes.size, "no padding slot in the target range"
    h = holes[-1]
    dstl[h], valid[h] = dstl[e], True
    valid[e] = False
    return dstl, valid


@pytest.mark.parametrize("src_part,dst_part", [(2, 0), (0, 3), (1, 2)])
def test_part_ranges_raise_on_a_stray_edge(src_part, dst_part):
    L = _layout(10, 16, 16, False)
    SL = shard_layout(L, 4)
    dstl, valid = _moved(SL, 1, src_part, dst_part)
    with pytest.raises(ValueError, match="outside its destination"):
        part_ranges(torch.from_numpy(dstl), torch.from_numpy(valid), SL.q,
                    SL.kpd)


def test_part_ranges_raise_on_an_edge_past_the_ranges():
    """A valid edge in the tail padding, or one whose dst is the sentinel
    nv, lies in no partition's range."""
    L = _layout(9, 8, 64, True)
    SL = shard_layout(L, 2)
    for d in range(2):
        for dst_value in (0, SL.nv):
            dstl, valid = SL.in_dst_local[d].copy(), SL.in_valid[d].copy()
            last = int(_derive(SL, d).part_off[-1])
            if dst_value == 0:
                if last == SL.ne_d:
                    continue
                dstl[last], valid[last] = 0, True
            else:
                e = np.flatnonzero(valid)[0]
                dstl[e] = SL.nv
            with pytest.raises(ValueError, match="outside its destination"):
                part_ranges(torch.from_numpy(dstl), torch.from_numpy(valid),
                            SL.q, SL.kpd)


@pytest.fixture
def gloo_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_dist_engine_setup_derives_and_checks_ranges(gloo_mesh, monkeypatch):
    L = _layout(9, 8, 64, True)
    SL = shard_layout(L, 1)
    eng = port_dist.DistEngine(SL, sssp_program(), gloo_mesh, mode="dc")
    pr = eng.arrays["in_parts"]
    np.testing.assert_array_equal(pr.part_off.numpy(),
                                  _blk_ranges(L, SL.kpd, 0))
    assert (pr.q, pr.tile) == (SL.q, L.edge_tile)
    dstl, valid = _moved(SL, 0, 3, 1)
    SL.in_dst_local[0], SL.in_valid[0] = dstl, valid
    with pytest.raises(ValueError, match="outside its destination"):
        port_dist.DistEngine(SL, bfs_program(), gloo_mesh, mode="dc")
    monkeypatch.setenv("REPRO_FUSED", "0")
    eng = port_dist.DistEngine(SL, bfs_program(), gloo_mesh, mode="dc")
    assert not eng.fused and "in_parts" not in eng.arrays


# ----------------------------------------------------------------------
# the kernel's two call forms on a rank's received bins
# ----------------------------------------------------------------------

STREAM_CASES = [(m, d, None) for m in ("add", "min", "max")
                for d in ("float32", "int32", "uint32")]
STREAM_CASES += [("min", "float32", "add_weight"),
                 ("add", "float32", "add_weight")]


@pytest.fixture(scope="module")
def bins():
    """Rank 1 of a D = 2 sharding: its received edges, their ranges, a
    table of D*S + 1 slots with mixed validity, and integer-valued weights
    (so that f32 sums are exact in any order)."""
    L = _layout(8, 8, 16, True)
    SL = shard_layout(L, 2)
    d, m = 1, SL.D * SL.S + 1
    rng = np.random.default_rng(11)
    return dict(idx=SL.in_msg_slot[d], evalid=SL.in_valid[d],
                dst=SL.in_dst_local[d], ns=SL.nv + 1, m=m,
                w=rng.integers(0, 9, SL.ne_d).astype(np.float32),
                tvalid=rng.random(m) < 0.7, parts=_derive(SL, d))


def _same(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, what
    assert np.array_equal(port.view(np.uint8), ref.view(np.uint8)), what


@pytest.mark.parametrize("monoid,dtype,edge", STREAM_CASES)
def test_fused_stream_with_parts_matches_reference(bins, monoid, dtype,
                                                   edge):
    b = bins
    lo = 0 if dtype == "uint32" else -64
    table = np.random.default_rng(len(monoid) + len(dtype)).integers(
        lo, 64, b["m"]).astype(dtype)
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a) for a in (b["tvalid"], b["idx"], b["evalid"],
                                          b["dst"])]
    kern = FusedStreamKernel(monoid, tdt)
    port_table = torch.from_numpy(
        table.view(np.int32) if dtype == "uint32" else table).view(tdt)
    kw = dict(w=torch.from_numpy(b["w"]) if edge else None,
              apply_weight=add_weight if edge else None)
    got = [kern(port_table, *args, b["ns"], **kw, parts=p)
           for p in (None, b["parts"])]
    jargs = [jnp.asarray(a) for a in (table, b["tvalid"], b["idx"],
                                      b["evalid"], b["dst"])]
    relax = (lambda v, wt: v + wt) if edge else None
    jw = jnp.asarray(b["w"]) if edge else None
    ref = ref_ops.FusedStreamKernel(monoid, dtype, interpret=True, tile=32,
                                    q=16)(*jargs, b["ns"], w=jw,
                                          apply_weight=relax)
    oracle = ref_fused_step.ref_fused_scatter_fold(
        RM.REGISTRY[monoid](jnp.dtype(dtype)), *jargs, b["ns"],
        apply_weight=relax, w=jw)
    for i, (acc, touched) in enumerate(got):
        for want, name in ((ref, "reference"), (oracle, "oracle")):
            _same(TM.as_bits(acc).numpy().view(dtype), want[0],
                  f"acc, parts={i}, {name}")
            _same(touched.numpy(), want[1], f"touched, parts={i}, {name}")
    assert got[1][1].any()


@pytest.mark.parametrize("edge", [None, "add_weight_to_key"])
def test_fused_stream_int64_with_parts_matches_reference(bins, edge):
    b = bins
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50, b["m"]).astype(np.float32)
    payload = rng.integers(0, 2**32, b["m"], dtype=np.uint64)
    words = (keys.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | payload
    kern = FusedStreamKernel("min_with_payload", torch.int64)
    args = [torch.from_numpy(a) for a in (words.view(np.int64), b["tvalid"],
                                          b["idx"], b["evalid"], b["dst"])]
    kw = dict(w=torch.from_numpy(b["w"]) if edge else None,
              apply_weight=add_weight_to_key if edge else None)
    got = [kern(*args, b["ns"], **kw, parts=p) for p in (None, b["parts"])]
    with jax.enable_x64(True):
        def relax(v, wt):
            key, pay = RM.unpack_key_payload(v)
            return RM.pack_key_payload(key + wt, pay)
        ref = ref_fused_step.ref_fused_scatter_fold(
            RM.min_with_payload(), jnp.asarray(words),
            jnp.asarray(b["tvalid"]), jnp.asarray(b["idx"]),
            jnp.asarray(b["evalid"]), jnp.asarray(b["dst"]), b["ns"],
            apply_weight=relax if edge else None,
            w=jnp.asarray(b["w"]) if edge else None)
        ref = [np.asarray(r) for r in ref]
    for i, (acc, touched) in enumerate(got):
        t = touched.numpy()
        _same(t, ref[1], f"touched, parts={i}")
        # the identities differ (INT64_MAX, the reference's UINT64_MAX)
        _same(packed_to_numpy(acc)[t], ref[0][t], f"acc, parts={i}")
        assert np.all(acc.numpy()[~t] == np.iinfo(np.int64).max)
    assert got[1][1].any()

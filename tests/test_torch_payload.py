"""The port's 8-byte slice on the CPU against ``repro``'s.

``min_with_payload`` words are ``uint64`` in the reference and ``int64``
here, with identities ``UINT64_MAX`` and ``INT64_MAX``: every word the
apps make has a key with its sign bit clear, so the two carriers order
the same bits alike, and :func:`_as_reference` maps the one identity onto
the other.  The reference's 8-byte code runs under the x64 shim of
``torch_reference_shims``.  Checked: packing, the monoid, the plain
versions of the four folds on packed payloads (random non-negative f32
keys, +inf, any uint32 payload) against the reference's ``Ref*`` kernels,
and ``sssp_with_parents``, ``sssp_parents_multi`` and ``bfs_seeded_multi``
against the reference on both of the port's DC lowerings, bit-exact.  The
layout is the reference serving tests' (``tests/test_serve.py``): RMAT
scale 8, weighted, ``k=8``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps as ref_apps
import repro_torch as rt
from repro.apps.bfs import bfs_seeded_multi, bfs_seeded_pack
from repro.apps import sssp_parents as ref_sp
from repro.core import monoid as RM
from repro.graph import build_layout, rmat
from repro.kernels import ops as ref_ops
from repro_torch.core import monoid as M
from repro_torch.interop import (layout_from_reference, packed_to_numpy,
                                 state_to_torch)
from repro_torch.kernels import _build, ops
from repro_torch.kernels.fold_block import lane_segment_fold, segment_fold
from repro_torch.kernels.fused_step import add_weight_to_key
from torch_reference_shims import (same_batch_stats, same_bits,
                                   same_iter_stats, x64)  # noqa: F401

torch.set_num_threads(1)

LOWERINGS = ("fused", "composed")
INT64_MAX = np.uint64(2**63 - 1)
UINT64_MAX = np.uint64(2**64 - 1)


@pytest.fixture(scope="module")
def layouts():
    L = build_layout(rmat(8, 8, seed=3, weighted=True), k=8, edge_tile=64,
                     msg_tile=32)
    return L, layout_from_reference(L)


@pytest.fixture
def lowering(request, monkeypatch):
    """``REPRO_FUSED`` for both packages' engines built in the test."""
    monkeypatch.setenv("REPRO_FUSED", "1" if request.param == "fused" else "0")
    return request.param


def _sources(layout, b):
    return [int(s) for s in np.linspace(0, layout.n - 1, b).astype(np.int64)]


def _packed(rng, n):
    """Packed words of random non-negative f32 keys (a tenth +inf) and
    random uint32 payloads, as the reference's ``uint64``."""
    keys = rng.random(n, dtype=np.float32) * np.float32(100)
    keys[rng.random(n) < 0.1] = np.inf
    payload = rng.integers(0, 2**32, n, dtype=np.uint64)
    return (keys.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | payload


def _as_reference(words):
    """Port words (int64 tensor) as the reference's uint64, the identity
    ``INT64_MAX`` mapped onto ``UINT64_MAX``."""
    u = packed_to_numpy(words)
    return np.where(u == INT64_MAX, UINT64_MAX, u)


def test_monoid_and_codes():
    mono = M.min_with_payload()
    assert (mono.name, mono.dtype, mono.identity) == (
        "min_with_payload", torch.int64, 2**63 - 1)
    assert M.REGISTRY["min_with_payload"]() == mono
    a, b = torch.tensor([5, 2**62, 7]), torch.tensor([3, 2**61, 2**63 - 1])
    assert mono.combine(a, b).tolist() == [3, 2**61, 7]
    assert _build.dtype_code(torch.int64, "min_with_payload") == \
        _build.dtype_code(torch.int64, "min") == 3
    for monoid in ("add", "max", "or"):
        with pytest.raises(TypeError, match="min only"):
            _build.dtype_code(torch.int64, monoid)


@pytest.mark.parametrize("payload", [0, 0xFFFFFFFF])
def test_pack_unpack_matches_reference(x64, payload):
    keys = np.array([0.0, np.float32(1e-45), 1.5, np.inf], np.float32)
    pay = np.full(4, payload, np.uint32)
    with jax.experimental.enable_x64():
        want = np.asarray(RM.pack_key_payload(jnp.asarray(keys),
                                              jnp.asarray(pay)))
        wk, wp = RM.unpack_key_payload(jnp.asarray(want))
    got = M.pack_key_payload(torch.from_numpy(keys),
                             torch.from_numpy(pay.view(np.int32)).view(
                                 torch.uint32))
    same_bits(packed_to_numpy(got), want)
    key, pl = M.unpack_key_payload(got)
    same_bits(key.numpy(), np.asarray(wk))
    same_bits(pl.numpy(), np.asarray(wp))
    assert bool((got >= 0).all()) and bool((got < 2**63 - 1).all())


@pytest.mark.parametrize("seed", range(3))
def test_plain_int64_folds_match_reference(x64, seed):
    """The plain segment fold (single and lanes) against
    ``jax.ops.segment_min`` on the reference's uint64 words through its
    ``RefFold``."""
    rng = np.random.default_rng(seed)
    n, ns = 3000, 257
    words = _packed(rng, n)
    valid = rng.random(n) < 0.8
    ids = rng.integers(-3, ns + 3, n).astype(np.int32)
    keep = (ids >= 0) & (ids < ns)
    with jax.experimental.enable_x64():
        want_acc, want_t = ref_ops.RefFold(RM.min_with_payload())(
            jnp.asarray(words), jnp.asarray(valid & keep),
            jnp.asarray(np.where(keep, ids, 0)), ns)
        want_acc, want_t = np.asarray(want_acc), np.asarray(want_t)
    t_words = torch.from_numpy(words.view(np.int64))
    acc, touched = segment_fold(t_words, torch.from_numpy(valid),
                                torch.from_numpy(ids), ns,
                                "min_with_payload")
    same_bits(touched.numpy(), want_t)
    same_bits(_as_reference(acc), want_acc)
    lanes = torch.stack([t_words, t_words.flip(0)])
    lacc, lt = lane_segment_fold(lanes, torch.from_numpy(valid).expand(2, n),
                                 torch.from_numpy(ids), ns, "min")
    assert torch.equal(lacc[0], acc) and torch.equal(lt[0], touched)


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_int64_layout_kernels_match_reference(x64, layouts, weighted):
    """The fused DC step (with ``add_weight_to_key`` or none), the DC
    scatter and the gather fold of the composed path, through the port's
    ``ops`` classes on the CPU, against the reference's ``RefFusedDC``,
    ``RefScatter`` and ``RefGather`` on the same packed words."""
    L, TL = layouts
    rng = np.random.default_rng(5)
    ns = L.n_pad + 1
    table, tvalid = _packed(rng, ns), rng.random(ns) < 0.5
    x, act = table[:L.n_pad], tvalid[:L.n_pad]
    edge_vals = _packed(rng, L.num_edges)
    # the engine's edge validity never marks a pad edge
    edge_valid = (rng.random(L.num_edges) < 0.8) & L.edge_valid.astype(bool)
    part_active = rng.random(L.k) < 0.7
    mono = RM.min_with_payload()
    with jax.experimental.enable_x64():
        ref_fused = ref_ops.RefFusedDC(L, mono)
        if weighted:
            ref_fused.apply_weight = ref_sp.sssp_parents_program().apply_weight
        want = [np.asarray(a) for a in ref_fused(jnp.asarray(table),
                                                 jnp.asarray(tvalid))]
        want_bins = np.asarray(ref_ops.RefScatter(L, mono)(
            jnp.asarray(x), jnp.asarray(act)))
        want_g = [np.asarray(a) for a in ref_ops.RefGather(L, mono)(
            jnp.asarray(edge_vals), jnp.asarray(edge_valid),
            jnp.asarray(part_active))]
    words = lambda a: torch.from_numpy(a.view(np.int64))
    kern = ops.FusedDCKernel(TL, "min_with_payload", torch.int64, "cpu",
                             apply_weight=add_weight_to_key if weighted
                             else None)
    acc, touched = kern(words(table), torch.from_numpy(tvalid))
    same_bits(touched.numpy(), want[1])
    same_bits(_as_reference(acc), want[0])
    sk = ops.ScatterKernel(TL, "min_with_payload", torch.int64, "cpu")
    same_bits(_as_reference(sk(words(x), torch.from_numpy(act))), want_bins)
    gk = ops.GatherKernel(TL, "min_with_payload", torch.int64, "cpu")
    gacc, gt = gk(words(edge_vals), torch.from_numpy(edge_valid),
                  torch.from_numpy(part_active))
    same_bits(gt.numpy(), want_g[1][:L.n_pad])
    same_bits(_as_reference(gacc), want_g[0][:L.n_pad])


def test_state_crosses_as_int64(x64):
    rng = np.random.default_rng(2)
    words = _packed(rng, 64)
    state = state_to_torch(
        {"best": words, "vid": np.arange(64, dtype=np.uint32)}, device="cpu")
    assert state["best"].dtype == torch.int64
    assert state["vid"].dtype == torch.uint32
    same_bits(packed_to_numpy(state["best"]), words)
    with pytest.raises(TypeError):
        packed_to_numpy(state["vid"])


@pytest.mark.parametrize("mode", ["hybrid", "dc", "sc"])
@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_sssp_with_parents_matches_reference(x64, layouts, lowering, mode):
    L, TL = layouts
    src = int(np.argmax(L.deg[:L.n]))
    ref = ref_sp.sssp_with_parents(L, src, mode=mode)
    eng = rt.Engine(TL, rt.apps.sssp_parents_program(), mode=mode,
                    device="cpu")
    assert eng.fused == (lowering == "fused")
    port = rt.sssp_with_parents(TL, src, engine=eng)
    same_bits(port["dist"], ref["dist"])
    same_bits(port["parent"], ref["parent"])
    same_iter_stats(port["stats"], ref["stats"])
    same_bits(port["dist"], rt.sssp(TL, src, mode=mode, device="cpu")["dist"])


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_sssp_parents_multi_matches_reference(x64, layouts, lowering):
    L, TL = layouts
    sources = _sources(L, 8)
    ref = ref_sp.sssp_parents_multi(L, sources)
    port = rt.sssp_parents_multi(TL, sources, device="cpu")
    same_bits(port["dist"], ref["dist"])
    same_bits(port["parent"], ref["parent"])
    same_batch_stats(port["stats"], ref["stats"])
    for i in (0, 5):
        seq = rt.sssp_with_parents(TL, sources[i], device="cpu")
        same_bits(port["dist"][i], seq["dist"])
        same_bits(port["parent"][i], seq["parent"])


def _seeds(L, sources, cold, mixed):
    """Upper-bound seeds from the cold levels (+1 on every reached vertex,
    parent unknown), with the last lane cold when ``mixed``."""
    B = len(sources)
    levels = np.full((B, L.n_pad), -1, np.int64)
    levels[:, :L.n] = np.where(cold >= 0, cold + 1, -1)
    parents = np.full((B, L.n_pad), -1, np.int64)
    levels[np.arange(B), sources] = 0
    parents[np.arange(B), sources] = sources
    if mixed:
        levels[-1] = -1
        parents[-1] = -1
        levels[-1, sources[-1]] = 0
        parents[-1, sources[-1]] = sources[-1]
    return levels, parents, levels >= 0


@pytest.mark.parametrize("case", ["cold", "seeded", "mixed"])
@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_bfs_seeded_multi_matches_reference(x64, layouts, lowering, case):
    L, TL = layouts
    sources = _sources(L, 4)
    cold = ref_apps.bfs_multi(L, sources, backend="ref")
    if case == "cold":
        kw = {}
    else:
        levels, parents, frontiers = _seeds(L, np.array(sources),
                                            cold["level"], case == "mixed")
        kw = dict(seed_levels=levels, seed_parents=parents,
                  frontiers=frontiers)
    ref = bfs_seeded_multi(L, sources, **kw)
    port = rt.bfs_seeded_multi(TL, sources, device="cpu", **kw)
    same_bits(port["level"], ref["level"])
    same_bits(port["parent"], ref["parent"])
    same_batch_stats(port["stats"], ref["stats"])
    # every case converges to the cold BFS tree
    same_bits(port["level"], cold["level"])
    same_bits(port["parent"], cold["parent"])
    if case == "seeded":
        with jax.experimental.enable_x64():
            packed = np.asarray(bfs_seeded_pack(
                jnp.asarray(kw["seed_levels"]),
                jnp.asarray(kw["seed_parents"])))
        got = rt.bfs_seeded_multi(TL, sources, seeds=packed,
                                  frontiers=kw["frontiers"], device="cpu")
        same_bits(got["level"], ref["level"])
        same_bits(got["parent"], ref["parent"])

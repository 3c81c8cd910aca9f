"""The port's fused DC step and segment folds against the reference's.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
references are the Pallas kernels in interpret mode and the pure-jnp
oracle.  Cases come from the shared differential harness
(``tests/kernel_harness.py``): {add,min,max} x {f32,i32,u32}, duplicate and
out-of-order ids, all-invalid slots, the over-cap ``NS_Q_PAIRS``.  Payloads
are integer-valued, so every comparison is bit-exact, f32 add included.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # optional dev dep (requirements-dev.txt)
from hypothesis import given, settings, strategies as st

from kernel_harness import (FOLD_TILES, NS_Q_PAIRS, NUM_SEGMENTS,
                            draw_fused_case, draw_monoid, draw_stream,
                            payload)
from repro.core import monoid as RM
from repro.kernels import fold_block as ref_fold_block
from repro.kernels import fold_two_level as ref_fold_two_level
from repro.kernels import fused_step as ref_fused_step
from repro_torch.core import monoid as TM
from repro_torch.interop import state_to_torch, to_torch
from repro_torch.kernels import spmv_block as port_spmv_block
from repro_torch.kernels._build import CSRC
from repro_torch.kernels.fold_block import (blocked_segment_fold,
                                            segment_fold_cuda)
from repro_torch.kernels.fold_two_level import two_level_segment_fold
from repro_torch.kernels.fused_step import add_weight, fused_scatter_fold
from repro_torch.kernels.spmv_block import spmv_block_cuda

torch.set_num_threads(1)

EDGE_TILES = (8, 16)
FOLD_QS = (3, 7, 8)


def _relax(v, w):
    """The reference side of ``add_weight``; module-level so the jit cache
    keys on one callable across examples."""
    return v + w


def _assert_bit_exact(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), (
            f"component {i} diverges: port={g!r} reference={w!r}")


def _port(*arrays):
    return [to_torch(a, device="cpu") for a in arrays]


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.data())
def test_blocked_fold_matches_reference(data):
    monoid, dtype, _ = draw_monoid(data)
    ns = data.draw(st.sampled_from(NUM_SEGMENTS))
    tile = data.draw(st.sampled_from(FOLD_TILES))
    vals, valid, ids = draw_stream(data, ns, dtype)
    _assert_bit_exact(
        blocked_segment_fold(*_port(vals, valid, ids), ns, monoid=monoid),
        ref_fold_block.blocked_segment_fold(vals, valid, ids, ns,
                                            monoid=monoid, fold_tile=tile,
                                            interpret=True))


@settings(max_examples=20, deadline=None, derandomize=True)
@given(st.data())
def test_two_level_fold_matches_reference_overcap(data):
    monoid, dtype, _ = draw_monoid(data)
    ns, q = data.draw(st.sampled_from(NS_Q_PAIRS))
    tile = data.draw(st.sampled_from(FOLD_TILES))
    vals, valid, ids = draw_stream(data, ns, dtype)
    _assert_bit_exact(
        two_level_segment_fold(*_port(vals, valid, ids), ns, monoid=monoid),
        ref_fold_two_level.two_level_segment_fold(
            vals, valid, ids, ns, monoid=monoid, fold_tile=tile, fold_q=q,
            interpret=True))


@pytest.mark.parametrize("fold", ["blocked", "two_level"])
@pytest.mark.parametrize("monoid", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32"])
def test_fold_drops_invalid_and_out_of_range(fold, monoid, dtype):
    """Ids below 0 or at and past ``num_segments`` and invalid slots
    contribute nothing; an all-invalid stream folds to the identity."""
    ns, n = 9, 64
    rng = np.random.default_rng(7)
    vals = payload(rng, n, dtype)
    ids = jnp.asarray(rng.integers(-4, ns + 4, n).astype(np.int32))
    port_fn = (blocked_segment_fold if fold == "blocked"
               else two_level_segment_fold)
    for valid in (jnp.asarray(rng.random(n) < 0.5), jnp.zeros(n, bool)):
        if fold == "blocked":
            want = ref_fold_block.blocked_segment_fold(
                vals, valid, ids, ns, monoid=monoid, fold_tile=16,
                interpret=True)
        else:
            want = ref_fold_two_level.two_level_segment_fold(
                vals, valid, ids, ns, monoid=monoid, fold_tile=16, fold_q=4,
                interpret=True)
        _assert_bit_exact(port_fn(*_port(vals, valid, ids), ns,
                                  monoid=monoid), want)


@pytest.mark.parametrize("monoid", ["add", "min", "max"])
def test_two_level_fold_matches_reference_past_the_shared_regime(monoid):
    """Past the CUDA fold's shared-memory regime the port's fold is still
    the reference's two-level fold: a stream into 40,961 segments (one past
    ``kSharedMaxSegments`` in csrc/segment_fold.cu), ids spread over all of
    them and runs of equal ids included."""
    ns = 40961
    rng = np.random.default_rng(12)
    n = 256
    vals = payload(rng, n, "int32")
    ids = np.concatenate([rng.integers(-3, ns + 3, n - 64),
                          np.full(64, ns - 1)]).astype(np.int32)
    valid = jnp.asarray(rng.random(n) < 0.8)
    ids = jnp.asarray(ids)
    _assert_bit_exact(
        two_level_segment_fold(*_port(vals, valid, ids), ns, monoid=monoid),
        ref_fold_two_level.two_level_segment_fold(
            vals, valid, ids, ns, monoid=monoid, fold_tile=128, fold_q=8192,
            interpret=True))


@pytest.mark.parametrize("name, source, constant", [
    ("MAX_CHUNK", "spmv_block.cu", "kMaxChunk")])
def test_python_mirrors_of_kernel_constants(name, source, constant):
    """The wrappers' copies of the CUDA sources' limits (the SpMV's widest
    block slice) match the sources."""
    import re
    text = (CSRC / source).read_text()
    found = re.search(rf"constexpr [a-z ]+{constant} = (\d+);", text)
    assert found and int(found.group(1)) == getattr(port_spmv_block, name)


@pytest.mark.parametrize("dtype", ["int32", "uint32"])
def test_integer_add_wraps_like_reference(dtype):
    """Integer add wraps mod 2**32 in both packages (uint32 is folded
    widened on the CPU and narrowed back)."""
    info = np.iinfo(dtype)
    vals = jnp.asarray(np.array([info.max, info.max - 5, 9, info.max, 1],
                                dtype))
    valid = jnp.ones(5, bool)
    ids = jnp.asarray(np.array([0, 0, 0, 1, 1], np.int32))
    _assert_bit_exact(
        blocked_segment_fold(*_port(vals, valid, ids), 3, monoid="add"),
        ref_fold_block.blocked_segment_fold(vals, valid, ids, 3,
                                            monoid="add", fold_tile=8,
                                            interpret=True))


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.data())
def test_fused_matches_reference(data):
    monoid, dtype, mono = draw_monoid(data)
    ns = data.draw(st.sampled_from(NUM_SEGMENTS))
    tile = data.draw(st.sampled_from(EDGE_TILES))
    q = data.draw(st.sampled_from(FOLD_QS))
    case = draw_fused_case(data, ns, dtype)
    got = fused_scatter_fold(*_port(*case), ns, monoid=monoid)
    _assert_bit_exact(got, ref_fused_step.fused_scatter_fold(
        *case, ns, monoid=monoid, edge_tile=tile, fold_q=q, interpret=True))
    _assert_bit_exact(got, ref_fused_step.ref_fused_scatter_fold(
        mono, *case, ns))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(st.data())
def test_fused_matches_reference_overcap(data):
    monoid, dtype, _ = draw_monoid(data)
    ns, q = data.draw(st.sampled_from(NS_Q_PAIRS))
    case = draw_fused_case(data, ns, dtype)
    _assert_bit_exact(
        fused_scatter_fold(*_port(*case), ns, monoid=monoid),
        ref_fused_step.fused_scatter_fold(*case, ns, monoid=monoid,
                                          edge_tile=16, fold_q=q,
                                          interpret=True))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(st.data())
def test_fused_add_weight_matches_reference(data):
    """SSSP's edge function inside the fused step (f32 min)."""
    ns = data.draw(st.sampled_from(NUM_SEGMENTS))
    table, tvalid, idx, evalid, dst = draw_fused_case(data, ns, "float32")
    rng = np.random.default_rng(data.draw(st.integers(0, 10**6)))
    w = payload(rng, idx.shape[0], "float32")
    got = fused_scatter_fold(*_port(table, tvalid, idx, evalid, dst), ns,
                             monoid="min", apply_weight=add_weight,
                             w=to_torch(w, device="cpu"))
    _assert_bit_exact(got, ref_fused_step.fused_scatter_fold(
        table, tvalid, idx, evalid, dst, ns, monoid="min", edge_tile=8,
        fold_q=7, interpret=True, apply_weight=_relax, w=w))
    _assert_bit_exact(got, ref_fused_step.ref_fused_scatter_fold(
        RM.min_(jnp.float32), table, tvalid, idx, evalid, dst, ns,
        apply_weight=_relax, w=w))


def test_wrappers_raise_on_unsupported_device():
    x = torch.zeros(4, device="meta")
    valid = torch.zeros(4, dtype=torch.bool, device="meta")
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        blocked_segment_fold(x, valid, ids, 3, monoid="min")
    with pytest.raises(ValueError, match="device"):
        fused_scatter_fold(x, valid, ids, valid, ids, 3, monoid="min")


@pytest.mark.parametrize("kernel", ["segment_fold", "spmv_block"])
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    """The CUDA kernels' wrappers check their inputs before any build or
    launch: a CPU tensor is refused, not folded by the plain version."""
    x = torch.zeros(4)
    valid = torch.zeros(4, dtype=torch.bool)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        if kernel == "segment_fold":
            segment_fold_cuda(x, valid, ids, 3, "min")
        else:
            spmv_block_cuda(x.view(1, 4), ids, ids, valid, None, ids[:1],
                            torch.zeros(2, dtype=torch.int64), k=1, q=4,
                            edge_tile=4)


@pytest.mark.parametrize("name", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32"])
def test_monoid_identity_and_combine_match_reference(name, dtype):
    """Identities equal the reference's; ``combine`` (uint32 widened to
    int64 and narrowed back) matches jnp elementwise, wraparound included."""
    ref = RM.REGISTRY[name](jnp.dtype(dtype))
    port = TM.REGISTRY[name](getattr(torch, dtype))
    want_ident = np.asarray(ref.identity)
    got_ident = port.identity_array((1,), "cpu").numpy()[0]
    assert got_ident.dtype == want_ident.dtype
    assert got_ident.tobytes() == want_ident.tobytes()
    rng = np.random.default_rng(11)
    info = (np.iinfo(dtype) if dtype != "float32"
            else np.iinfo(np.int32))
    a = rng.integers(max(info.min, -2**31), info.max, 64, dtype=np.int64)
    b = rng.integers(max(info.min, -2**31), info.max, 64, dtype=np.int64)
    a, b = a.astype(dtype), b.astype(dtype)
    want = np.asarray(ref.combine(jnp.asarray(a), jnp.asarray(b)))
    got = port.combine(to_torch(a, device="cpu"),
                       to_torch(b, device="cpu")).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_uint32_where_keeps_values_above_2_to_the_31():
    a = to_torch(np.array([0, 2**31, 2**32 - 1], np.uint32), device="cpu")
    b = to_torch(np.array([5, 6, 7], np.uint32), device="cpu")
    got = TM.where(torch.tensor([True, True, False]), a, b)
    assert got.dtype == torch.uint32
    assert got.numpy().tolist() == [0, 2**31, 7]
    assert TM.widen(a).tolist() == [0, 2**31, 2**32 - 1]


def test_state_to_torch_keeps_dtypes():
    state = {"label": jnp.arange(5, dtype=jnp.uint32),
             "dist": np.full(5, np.inf, np.float32),
             "parent": jnp.full(5, -1, jnp.int32),
             "active": np.ones(5, bool)}
    got = state_to_torch(state, device="cpu")
    assert {k: v.dtype for k, v in got.items()} == {
        "label": torch.uint32, "dist": torch.float32,
        "parent": torch.int32, "active": torch.bool}
    for k in state:
        assert np.array_equal(got[k].numpy(), np.asarray(state[k]))

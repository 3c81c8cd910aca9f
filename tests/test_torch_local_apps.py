"""The port's local apps on the CPU against ``repro.apps``: Nibble,
heat-kernel PageRank and PageRank-Nibble, the paper's selective-continuity
apps (``init_fn`` keeps vertices active, ``filter_fn`` drops them, and
heat-kernel PageRank's apply step reads the iteration).

Both packages get the same layout (RMAT scale 9, ``k=8``, ``edge_tile=64``,
``msg_tile=32``) and run from the highest-degree vertex, and from a pair of
seeds, in modes hybrid, dc and sc, on both DC lowerings.  The results agree
within 1e-6 (f32 adds are summed in another order) and the per-iteration
Eq. 1 records (mode, DC and SC partition counts, active vertices and edges)
are equal on these graphs.
"""
import numpy as np
import pytest
import torch

import repro.apps as ref_apps
import repro_torch as rt
from repro.graph import build_layout, rmat
from repro_torch.interop import layout_from_reference

torch.set_num_threads(1)

MODES = ("hybrid", "dc", "sc")
TOL = 1e-6


@pytest.fixture(scope="module")
def layouts():
    g = rmat(9, 8, seed=1)
    L = build_layout(g, k=8, edge_tile=64, msg_tile=32)
    return int(np.argmax(g.out_degrees())), L, layout_from_reference(L)


@pytest.fixture(params=["fused", "composed"])
def lowering(request, monkeypatch):
    """``REPRO_FUSED`` for both packages' engines built in the test."""
    monkeypatch.setenv("REPRO_FUSED", "1" if request.param == "fused" else "0")
    return request.param


def _seeds(src, L, which):
    return src if which == "hub" else [src, L.n // 3]


def _assert_same_stats(port, ref):
    key = lambda s: (s.it, s.mode, s.dc_parts, s.sc_parts, s.n_active,
                     s.e_active, s.dc_bytes, s.sc_bytes)
    assert [key(s) for s in port] == [key(s) for s in ref]
    assert all(s.program == r.program for s, r in zip(port, ref))


def _close(got, want):
    assert got.dtype == np.float32 and got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("seeds", ["hub", "pair"])
@pytest.mark.parametrize("mode", MODES)
def test_nibble_matches_reference(layouts, lowering, mode, seeds):
    src, L, TL = layouts
    s = _seeds(src, L, seeds)
    ref = ref_apps.nibble(L, s, mode=mode, backend="ref")
    port = rt.nibble(TL, s, mode=mode, device="cpu")
    _close(port["pr"], ref["pr"])
    _assert_same_stats(port["stats"], ref["stats"])


@pytest.mark.parametrize("seeds", ["hub", "pair"])
@pytest.mark.parametrize("mode", MODES)
def test_heat_kernel_pr_matches_reference(layouts, lowering, mode, seeds):
    src, L, TL = layouts
    s = _seeds(src, L, seeds)
    ref = ref_apps.heat_kernel_pr(L, s, mode=mode)
    port = rt.heat_kernel_pr(TL, s, mode=mode, device="cpu")
    _close(port["hkpr"], ref["hkpr"])
    _assert_same_stats(port["stats"], ref["stats"])


@pytest.mark.parametrize("seeds", ["hub", "pair"])
@pytest.mark.parametrize("mode", MODES)
def test_pagerank_nibble_matches_reference(layouts, lowering, mode, seeds):
    src, L, TL = layouts
    s = _seeds(src, L, seeds)
    ref = ref_apps.pagerank_nibble(L, s, mode=mode)
    port = rt.pagerank_nibble(TL, s, mode=mode, device="cpu")
    _close(port["ppr"], ref["ppr"])
    _close(port["residual"], ref["residual"])
    _assert_same_stats(port["stats"], ref["stats"])


def test_nibble_pallas_interpret_backend(layouts):
    """Nibble takes a backend in the reference: its Pallas kernels in
    interpret mode give the port's result too."""
    src, L, TL = layouts
    ref = ref_apps.nibble(L, src, max_iters=12, backend="pallas-interpret")
    port = rt.nibble(TL, src, max_iters=12, device="cpu")
    _close(port["pr"], ref["pr"])
    _assert_same_stats(port["stats"], ref["stats"])


def test_heat_kernel_reads_the_iteration(layouts):
    """The apply step scales the gathered mass by t / (it + 1): one step
    from a seed with out-degree d gives each out-neighbour t / d."""
    src, L, TL = layouts
    t = 3.0
    prog = rt.apps.heat_kernel_program(t, eps=1e-5)
    n_pad = TL.n_pad
    deg = torch.from_numpy(TL.deg.astype(np.float32))
    res = torch.zeros(n_pad)
    res[src] = 1.0
    eng = rt.Engine(TL, prog, mode="dc", device="cpu")
    active = torch.zeros(n_pad, dtype=torch.bool)
    active[src] = True
    for it, scale in ((0, t), (4, t / 5)):
        state, _ = eng.step({"sol": torch.zeros(n_pad), "res": res,
                             "deg": deg}, active, np.ones(TL.k, bool), it)
        nbrs = TL.csr_indices[TL.csr_indptr[src]:TL.csr_indptr[src + 1]]
        want = np.zeros(n_pad, np.float32)
        np.add.at(want, nbrs, np.float32(1.0 / TL.deg[src]))
        np.testing.assert_allclose(state["res"].numpy(), want * scale,
                                   rtol=1e-6)
        assert float(state["sol"][src]) == 1.0


@pytest.mark.parametrize("app", ["nibble", "heat_kernel_pr",
                                 "pagerank_nibble"])
def test_plain_engine_matches_default(layouts, app):
    """``Engine(plain=True)`` (what the card-side check of chip_smoke.py
    runs against) gives the default engine's result."""
    src, _, TL = layouts
    programs = {"nibble": rt.apps.nibble_program(1e-4),
                "heat_kernel_pr": rt.apps.heat_kernel_program(5.0, 1e-5),
                "pagerank_nibble": rt.apps.pagerank_nibble_program(0.15,
                                                                   1e-5)}
    fn = getattr(rt, app)
    eng = rt.Engine(TL, programs[app], device="cpu", plain=True)
    plain, port = fn(TL, src, engine=eng), fn(TL, src, device="cpu")
    for key, v in port.items():
        if key != "stats":
            assert np.array_equal(plain[key], v)
    assert len(plain["stats"]) == len(port["stats"])

"""The port's tile autotuner against the reference's: cache key, record
format, cache hits, and ``build_layout`` reading the winner.

Every test points ``REPRO_TUNING_DIR`` (or ``cache_dir``) at ``tmp_path``,
so nothing is written under ``results/``.  On the CPU the sweep times the
plain PyTorch versions (backend ``"plain"``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.graph as ref_graph
from repro.backend import tuning as ref_tuning
from repro_torch.backend import tuning
from repro_torch.graph import build_layout, rmat
from repro_torch.interop import layout_from_reference
from repro_torch.kernels.fold_block import ENV_FOLD_TILE
from repro_torch.kernels.fold_two_level import ENV_FOLD_Q

torch.set_num_threads(1)

ODD = tuning.TileGeometry(64, 32, 64, 64)   # a candidate no default equals


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.ENV_DIR, str(tmp_path))
    monkeypatch.delenv(ENV_FOLD_TILE, raising=False)
    monkeypatch.delenv(ENV_FOLD_Q, raising=False)
    return tmp_path


@pytest.fixture(scope="module")
def g():
    return rmat(9, 8, seed=1)


def _fake_times(winner):
    """A ``time_layout`` under which ``winner``'s layout is fastest."""
    def time_layout(layout, device, kernels=tuning.KERNEL_ROWS, reps=3,
                    monoid="add"):
        t = 1.0 if (layout.edge_tile, layout.msg_tile) == (
            winner.edge_tile, winner.msg_tile) else 2.0
        return {k: t for k in kernels}
    return time_layout


@pytest.mark.parametrize("args", [
    (4096, 65536, 8, False, "cpu", "plain"),
    (4194304, 65244445, 128, True, "cuda", "cuda"),
    (100, 800, 4, True, "cpu", "ref"),
])
def test_cache_key_is_the_references(args):
    assert tuning._cache_key(*args) == ref_tuning._cache_key(*args)


def test_autotune_writes_the_references_record(g, cache):
    geom = tuning.autotune(g, k=8, device="cpu", reps=1)
    files = list(cache.glob("*.json"))
    assert [f.name for f in files] == [
        tuning._cache_key(g.n, g.m, 8, False, "cpu", "plain") + ".json"]
    rec = json.loads(files[0].read_text())
    # the reference's own record on a small graph, for its key sets
    small = ref_graph.rmat(6, 8, seed=2)
    ref_tuning.autotune(small, k=4, backend="ref", cache_dir=cache / "ref",
                        reps=1)
    want = json.loads(next((cache / "ref").glob("*.json")).read_text())
    assert set(rec) == set(want)
    assert set(rec["graph"]) == set(want["graph"])
    assert {frozenset(s) for s in rec["sweep"]} \
        == {frozenset(s) for s in want["sweep"]}
    assert {frozenset(s["kernels"]) for s in rec["sweep"]} \
        == {frozenset(s["kernels"]) for s in want["sweep"]}
    assert (rec["platform"], rec["backend"]) == ("cpu", "plain")
    assert rec["graph"] == {"n": g.n, "m": g.m, "k": 8, "weighted": False}
    assert [(s["edge_tile"], s["msg_tile"], s["fold_tile"], s["fold_q"])
            for s in rec["sweep"]] == [
        (c.edge_tile, c.msg_tile, c.fold_tile, c.fold_q)
        for c in tuning.candidates("cpu")]
    for s in rec["sweep"]:
        assert s["wall_s"] == pytest.approx(sum(s["kernels"].values()))
        assert all(t > 0 for t in s["kernels"].values())
    best = min(rec["sweep"], key=lambda s: s["wall_s"])
    assert geom == tuning.TileGeometry(best["edge_tile"], best["msg_tile"],
                                       best["fold_tile"], best["fold_q"])
    assert (rec["edge_tile"], rec["msg_tile"], rec["fold_tile"],
            rec["fold_q"]) == (geom.edge_tile, geom.msg_tile,
                               geom.fold_tile, geom.fold_q)
    # with tiles unset, build_layout takes the winner from the cache
    L = build_layout(g, k=8)
    assert (L.edge_tile, L.msg_tile, L.fold_tile, L.fold_q) == (
        geom.edge_tile, geom.msg_tile, geom.fold_tile, geom.fold_q)


def test_second_autotune_reads_the_cache_without_timing(g, cache,
                                                        monkeypatch):
    calls = []
    fake = _fake_times(ODD)

    def counting(*a, **kw):
        calls.append(1)
        return fake(*a, **kw)

    monkeypatch.setattr(tuning, "time_layout", counting)
    assert tuning.autotune(g, k=8, device="cpu", reps=1) == ODD
    assert len(calls) == len(tuning.candidates("cpu"))
    assert tuning.autotune(g, k=8, device="cpu", reps=1) == ODD
    assert len(calls) == len(tuning.candidates("cpu"))
    L = tuning.tuned_layout(g, k=8, device="cpu")
    assert (L.edge_tile, L.msg_tile) == (ODD.edge_tile, ODD.msg_tile)
    assert len(calls) == len(tuning.candidates("cpu"))
    # force= sweeps again
    tuning.autotune(g, k=8, device="cpu", reps=1, force=True)
    assert len(calls) == 2 * len(tuning.candidates("cpu"))


def test_autotune_uses_a_layout_it_is_given(g, cache, monkeypatch):
    seen = []
    fake = _fake_times(ODD)

    def recording(layout, *a, **kw):
        seen.append(layout)
        return fake(layout, *a, **kw)

    monkeypatch.setattr(tuning, "time_layout", recording)
    given = build_layout(g, k=8, edge_tile=256, msg_tile=128, fold_tile=256,
                         fold_q=256)
    tuning.autotune(g, k=8, device="cpu", reps=1,
                    layouts={tuning.TileGeometry(256, 128, 256, 256): given})
    assert sum(L is given for L in seen) == 1


def test_build_layout_reads_the_winner_and_the_knobs_outrank_it(
        g, cache, monkeypatch):
    monkeypatch.setattr(tuning, "time_layout", _fake_times(ODD))
    tuning.autotune(g, k=8, device="cpu", reps=1)
    L = build_layout(g, k=8)
    assert (L.edge_tile, L.msg_tile, L.fold_tile, L.fold_q) == (64, 32, 64,
                                                               64)
    monkeypatch.setenv(ENV_FOLD_TILE, "48")
    monkeypatch.setenv(ENV_FOLD_Q, "40")
    L = build_layout(g, k=8)
    assert (L.edge_tile, L.msg_tile, L.fold_tile, L.fold_q) == (64, 32, 48,
                                                               40)
    # explicit arguments outrank both
    L = build_layout(g, k=8, edge_tile=128, fold_q=24)
    assert (L.edge_tile, L.msg_tile, L.fold_tile, L.fold_q) == (128, 32, 48,
                                                               24)


def test_port_and_reference_layouts_agree_beside_a_port_cache(g, cache,
                                                              monkeypatch):
    """A port cache entry is invisible to the reference (other key), and
    with tiles given both packages build the same arrays."""
    monkeypatch.setattr(tuning, "time_layout", _fake_times(ODD))
    tuning.autotune(g, k=8, device="cpu", reps=1)
    gr = ref_graph.rmat(9, 8, seed=1)
    assert ref_graph.build_layout(gr, k=8).edge_tile \
        == ref_tuning.DEFAULT_GEOMETRY.edge_tile
    tiles = dict(edge_tile=64, msg_tile=32, fold_tile=16, fold_q=24)
    want = layout_from_reference(ref_graph.build_layout(gr, k=8, **tiles))
    got = build_layout(g, k=8, **tiles)
    for name, a in vars(want).items():
        b = getattr(got, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name


def test_platform_follows_the_card(g, cache, monkeypatch):
    """``resolve_geometry`` reads the ``cuda-cuda`` entry when torch sees a
    card, the ``cpu-plain`` one otherwise."""
    monkeypatch.setattr(tuning, "time_layout", _fake_times(ODD))
    tuning.autotune(g, k=8, device="cpu", reps=1)
    key = tuning._cache_key(g.n, g.m, 8, False, "cuda", "cuda")
    rec = dict(json.loads(next(cache.glob("*.json")).read_text()),
               edge_tile=512, msg_tile=256, platform="cuda", backend="cuda")
    (cache / f"{key}.json").write_text(json.dumps(rec))
    assert tuning.resolve_geometry(g.n, g.m, 8).edge_tile == 64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tuning.default_platform() == "cuda"
    assert tuning.resolve_geometry(g.n, g.m, 8).edge_tile == 512
    assert tuning.candidates() == tuning.CANDIDATES["cuda"]


def test_cuda_candidates_sweep_only_the_tiles_the_kernels_read():
    cands = tuning.candidates("cuda")
    assert [c.edge_tile for c in cands] == [128, 256, 512, 1024]
    assert all(c.msg_tile == c.edge_tile // 2 for c in cands)
    assert {(c.fold_tile, c.fold_q) for c in cands} == {(256, 256)}
    assert tuning.candidates("cpu") == tuple(
        tuning.TileGeometry(*dataclasses.astuple(c))
        for c in ref_tuning.CANDIDATES["cpu"])


def test_autotune_on_the_default_device_raises_without_a_card(g, cache,
                                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tuning.autotune(g, k=8)

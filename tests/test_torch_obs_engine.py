"""The port's engine telemetry, exporters and kernel scopes on the CPU.

The port's engines record what the reference's record: ``engine_iter`` per
``Engine.run`` iteration, ``batch_iter`` and ``lane_compaction`` from the
batched loop, ``fused_run`` from ``run_fused``; the events must equal the
reference's field for field, wall times and timestamps aside, along with
the histogram series and cost samples they feed.  ``collect_stats=False``
and ``REPRO_OBS=0`` record nothing.  The exporters are copies and must
write the same bytes on the same registry content.  The kernel scopes are
``torch.profiler`` ranges, entered only while a profiler records.
"""
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro import obs as ref_obs
from repro.apps import bfs as ref_bfs
from repro.apps import bfs_multi as ref_bfs_multi
from repro.apps import pagerank as ref_pagerank
from repro.apps import sssp as ref_sssp
from repro.graph import build_layout, rmat
from repro.obs import export as ref_export
from repro.obs import metrics as ref_metrics
from repro_torch import obs
from repro_torch.interop import layout_from_reference
from repro_torch.obs import export, metrics

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOWERINGS = ("fused", "composed")


@pytest.fixture(scope="module")
def layouts():
    L = build_layout(rmat(8, 8, seed=3, weighted=True), k=8, edge_tile=64,
                     msg_tile=32)
    return L, layout_from_reference(L)


@pytest.fixture
def lowering(request, monkeypatch):
    monkeypatch.setenv("REPRO_FUSED", "1" if request.param == "fused" else "0")
    return request.param


@pytest.fixture
def both_on():
    """Telemetry on in both packages, with clean default registries."""
    with obs.override_enabled(True), ref_obs.override_enabled(True):
        obs.reset()
        ref_obs.reset()
        yield
    obs.reset()
    ref_obs.reset()


def _drop(events, *keys):
    return [{k: v for k, v in e.items() if k not in ("ts",) + keys}
            for e in events]


def _sizes(samples):
    """Cost samples without their wall times."""
    return [(mode, size) for mode, size, _ in samples]


def _hist_counts(o):
    return {key: h["count"]
            for key, h in o.snapshot()["histograms"].items()}


# ----------------------------------------------------------------------
# engine events against the reference's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
@pytest.mark.parametrize("app", ["bfs", "sssp"])
def test_engine_iter_events_match_reference(layouts, both_on, lowering,
                                            app):
    L, TL = layouts
    src = int(np.argmax(L.deg[:L.n]))
    run, ref_run = {"bfs": (rt.bfs, ref_bfs),
                    "sssp": (rt.sssp, ref_sssp)}[app]
    res = run(TL, src, device="cpu")
    ref_run(L, src)
    got, want = obs.events("engine_iter"), ref_obs.events("engine_iter")
    assert len(got) == len(res["stats"]) > 0
    assert all(obs.validate_event(e) == [] for e in got)
    assert _drop(got, "wall_s") == _drop(want, "wall_s")
    # the same field order too, so the JSONL lines match
    assert [list(e) for e in got] == [list(e) for e in want]
    assert {"dc_e", "sc_e"} <= got[0].keys()
    assert _sizes(obs.cost_samples()) == _sizes(ref_obs.cost_samples())
    assert _hist_counts(obs) == _hist_counts(ref_obs)


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_batched_events_match_reference(layouts, both_on, lowering):
    """Sources that drain at different steps, so lanes get compacted."""
    L, TL = layouts
    sources = [int(s) for s in np.linspace(0, L.n - 1, 6).astype(np.int64)]
    res = rt.bfs_multi(TL, sources, device="cpu")
    ref_bfs_multi(L, sources)
    for name in ("batch_iter", "lane_compaction"):
        got, want = obs.events(name), ref_obs.events(name)
        assert got and all(obs.validate_event(e) == [] for e in got)
        assert _drop(got, "wall_s") == _drop(want, "wall_s")
    assert len(obs.events("batch_iter")) == len(res["stats"])
    assert _sizes(obs.cost_samples()) == _sizes(ref_obs.cost_samples())
    assert _hist_counts(obs) == _hist_counts(ref_obs)


def test_fused_run_event_matches_reference(layouts, both_on):
    L, TL = layouts
    rt.pagerank(TL, iters=7, device="cpu")
    ref_pagerank(L, iters=7)
    got, want = obs.events("fused_run"), ref_obs.events("fused_run")
    assert len(got) == 1 and obs.validate_event(got[0]) == []
    assert _drop(got, "wall_s") == _drop(want, "wall_s")


@pytest.mark.parametrize("case", ["collect_stats_false", "obs_off"])
def test_silent_runs_record_nothing(layouts, case):
    """``collect_stats=False`` records no engine event; with telemetry off
    nothing is recorded at all (``fused_run`` and compactions included)."""
    _, TL = layouts
    sources = [0, 60, 120, 250]
    on = case == "collect_stats_false"
    with obs.override_enabled(on):
        obs.reset()
        prog = rt.apps.bfs_program()
        eng = rt.Engine(TL, prog, device="cpu")
        state = {"parent": torch.full((TL.n_pad,), -1, dtype=torch.int32),
                 "level": torch.full((TL.n_pad,), -1, dtype=torch.int32),
                 "vid": torch.arange(TL.n_pad, dtype=torch.int32).view(
                     torch.uint32)}
        state["parent"][0] = 0
        state["level"][0] = 0
        frontier = np.zeros(TL.n_pad, bool)
        frontier[0] = True
        eng.run(state, frontier, collect_stats=not on)
        res = rt.bfs_multi(TL, sources, device="cpu")
        if on:
            # the batched loop of bfs_multi keeps stats: only compactions
            # and steps of its own, no engine_iter
            assert obs.events("engine_iter") == []
            obs.reset()
            eng.run_batched(
                {k: v.expand(4, -1).clone() for k, v in state.items()},
                np.repeat(frontier[None], 4, 0), collect_stats=False)
            assert obs.events("batch_iter") == []
        else:
            assert len(res["stats"]) > 0
            rt.pagerank(TL, iters=3, device="cpu")
            assert obs.events() == [] and obs.snapshot()["histograms"] == {}
            assert obs.cost_samples() == []
        obs.reset()


def test_registry_finds_a_metric_by_its_call():
    """The registry's per-call lookup gives one series per label set, in
    any keyword order, takes unhashable label values, and forgets its
    metrics on reset."""
    reg = metrics.Registry(enabled=True)
    reg.observe("h", 1.0, a=1, b="x")
    reg.observe("h", 2.0, b="x", a=1)
    reg.inc("c", tag=[1, 2])
    reg.inc("c", tag=[1, 2])
    snap = reg.snapshot()
    assert snap["histograms"]["h{a=1,b=x}"]["count"] == 2
    assert snap["counters"] == {"c{tag=[1, 2]}": 2}
    reg.reset()
    reg.observe("h", 3.0, a=1, b="x")
    assert reg.snapshot()["histograms"]["h{a=1,b=x}"]["count"] == 1


# ----------------------------------------------------------------------
# exporters: the same bytes as the reference's
# ----------------------------------------------------------------------

def _drive(reg, rng):
    for i in range(120):
        name = ("bfs", "sssp", "cc")[i % 3]
        reg.inc("serve.cache_hits", int(rng.integers(1, 4)), app=name,
                layout="L1")
        reg.set_gauge("serve.queue_depth", float(rng.random()), layout="L1")
        reg.observe("serve.query_wall_s", float(rng.lognormal(-6, 2)),
                    app=name, layout="L1")
        reg.observe("engine.step_wall_s", float(rng.random()),
                    engine="core", mode="dc", program=name)
        reg.event("serve_query", app=name, layout="L1", cached=bool(i % 2),
                  wall_s=float(rng.random()))
        reg.event("engine_iter", engine="core", program=name, it=i,
                  mode="dc", n_active=i, e_active=2 * i,
                  wall_s=np.float32(rng.random()))


@pytest.mark.parametrize("seed", range(2))
def test_exporters_write_reference_bytes(seed, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    port = metrics.Registry(enabled=True, sink=str(tmp_path / "sink.jsonl"))
    ref = ref_metrics.Registry(enabled=True)
    _drive(port, np.random.default_rng(seed))
    _drive(ref, np.random.default_rng(seed))
    port.close()
    assert export.prometheus_text(port) == ref_export.prometheus_text(ref)
    assert export.write_jsonl(tmp_path / "port.jsonl", port) == 240
    ref_export.write_jsonl(tmp_path / "ref.jsonl", ref)
    want = (tmp_path / "ref.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == want
    # the registry's streaming sink writes the same lines, as they come
    assert (tmp_path / "sink.jsonl").read_bytes() == want
    # (a NumPy scalar goes through _json_default, whose int() comes first
    # in both packages: the wall_s of engine_iter reads back truncated)
    back = export.read_jsonl(tmp_path / "port.jsonl")
    assert [e for e in back if e["event"] == "serve_query"] \
        == port.events("serve_query")


def test_schema_tool_accepts_the_port_stream(layouts, both_on, tmp_path):
    """``tools/check_obs_schema.py`` (standard library only) on a stream of
    every engine event and a delta's."""
    _, TL = layouts
    rt.bfs(TL, 0, device="cpu")
    rt.bfs_multi(TL, [0, 60, 120, 250], device="cpu")
    rt.pagerank(TL, iters=2, device="cpu")
    rt.apply_delta(TL, rt.DeltaBuffer.for_layout(TL).insert(0, 1, 1.0))
    path = tmp_path / "events.jsonl"
    export.write_jsonl(path)
    spec = importlib.util.spec_from_file_location(
        "check_obs_schema", ROOT / "tools" / "check_obs_schema.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    need = "engine_iter,batch_iter,lane_compaction,fused_run,delta_apply"
    assert tool.main([str(path), "--require", need]) == 0
    assert tool.main([str(path), "--require", "epoch_swap"]) == 1


# ----------------------------------------------------------------------
# kernel scopes on torch.profiler
# ----------------------------------------------------------------------

def _scope_names(path):
    events = json.loads(Path(path).read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("name", "").startswith("ppm.")}


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_trace_holds_the_kernel_scopes(layouts, lowering, tmp_path):
    _, TL = layouts
    eng = rt.Engine(TL, rt.apps.pagerank_program(TL.n), mode="dc",
                    device="cpu")
    state = {"pr": torch.full((TL.n_pad,), 1.0 / TL.n),
             "deg": torch.from_numpy(TL.deg.astype(np.float32))}
    frontier = np.zeros(TL.n_pad, bool)
    frontier[:TL.n] = True
    path = tmp_path / "trace.json"
    with obs.override_enabled(True), obs.trace(path):
        eng.run(state, frontier, max_iters=1, until_empty=False)
    want = ({"ppm.fused_dc.plain"} if lowering == "fused"
            else {"ppm.scatter.plain", "ppm.gather.plain"})
    assert _scope_names(path) == want
    # the SC stream's fold has its scope too
    path2 = tmp_path / "trace_sc.json"
    sssp = rt.Engine(TL, rt.apps.sssp_program(), mode="sc", device="cpu")
    dist = torch.full((TL.n_pad,), float("inf"))
    dist[0] = 0.0
    with obs.override_enabled(True), obs.trace(path2):
        sssp.run({"dist": dist}, np.eye(1, TL.n_pad, 0, dtype=bool)[0],
                 max_iters=2)
    assert _scope_names(path2) == {"ppm.fold.plain"}


@pytest.mark.parametrize("lowering", LOWERINGS, indirect=True)
def test_no_scope_without_a_profiler(layouts, lowering, monkeypatch,
                                     tmp_path):
    """A run with no capture enters no ``record_function``; nor does a
    capture with telemetry off, as the reference's scopes are skipped."""
    _, TL = layouts
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with obs.override_enabled(True):
        rt.pagerank(TL, iters=2, device="cpu")
        rt.bfs(TL, 0, device="cpu")
        assert entered == []
        with obs.override_enabled(False), obs.trace(tmp_path / "off.json"):
            rt.pagerank(TL, iters=1, device="cpu")
        assert entered == []
        with obs.trace(tmp_path / "on.json"):
            rt.pagerank(TL, iters=1, device="cpu")
    assert entered and all(n.startswith("ppm.") for n in entered)
    assert obs.kernel_scope("x") is obs.annotation("y")

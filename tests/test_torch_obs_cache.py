"""The port's copies of the reference's telemetry and cache modules.

``repro_torch.obs`` (metrics registry, event schema) and
``repro_torch.serve.cache`` (key space, LRU and disk backends, semantic
entries, warmer, layout tags) are host code copied from ``repro``; here
each is driven through the same operations as the original and must give
the same results.  The one intended difference: the port's
``Histogram.percentile`` clamps to the observed ``[min, max]``, where the
reference's interpolation can land one ulp outside it.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro.graph import build_layout, rmat, symmetrize
from repro.obs import metrics as ref_metrics
from repro.obs import schema as ref_schema
from repro.serve import cache as ref_cache
from repro_torch import obs
from repro_torch.interop import layout_from_reference
from repro_torch.obs import metrics
from repro_torch.serve import cache

torch.set_num_threads(1)


def _drive(reg, rng):
    """The same recordings on a registry of either package."""
    for i in range(200):
        name = ("a", "b")[i % 2]
        reg.inc(f"c.{name}", int(rng.integers(1, 4)), app=name, layout="L")
        reg.set_gauge("g.depth", float(rng.random()), layout="L")
        reg.observe("h.wall", float(rng.lognormal(-6, 2)), app=name)
        reg.event("serve_query", app=name, layout="L", cached=bool(i % 3),
                  wall_s=float(rng.random()))
        reg.cost_sample("dc", i, 1e-3 * i, it=i)


@pytest.mark.parametrize("seed", range(3))
def test_registry_matches_reference(seed):
    port, ref = metrics.Registry(enabled=True), ref_metrics.Registry(
        enabled=True)
    _drive(port, np.random.default_rng(seed))
    _drive(ref, np.random.default_rng(seed))
    ps, rs = port.snapshot(), ref.snapshot()
    assert ps["counters"] == rs["counters"] and ps["gauges"] == rs["gauges"]
    assert ps["histograms"].keys() == rs["histograms"].keys()
    for key, want in rs["histograms"].items():
        got = ps["histograms"][key]
        for stat in ("count", "sum", "min", "max"):
            assert got[stat] == want[stat]
        for p in ("p50", "p95", "p99"):
            assert got[p] == min(max(want[p], want["min"]), want["max"])
    assert port.cost_samples("dc") == ref.cost_samples("dc")
    drop = lambda evs: [{k: v for k, v in e.items() if k != "ts"}
                        for e in evs]
    assert drop(port.events("serve_query")) == drop(ref.events("serve_query"))
    port.reset_metric("c.a", layout="L")
    ref.reset_metric("c.a", layout="L")
    assert port.snapshot()["counters"] == ref.snapshot()["counters"]


def test_percentile_clamps_where_the_reference_does_not():
    """Two equal observations of 3.0: the reference's 1st percentile is
    2.9999999999999996, below its own minimum; the port's is 3.0."""
    port, ref = metrics.Histogram("h", {}), ref_metrics.Histogram("h", {})
    for h in (port, ref):
        h.observe(3.0)
        h.observe(3.0)
    assert ref.percentile(1) == 2.9999999999999996 < ref.min
    assert port.percentile(1) == 3.0


@pytest.mark.parametrize("seed", range(4))
def test_percentiles_stay_within_the_observations(seed):
    rng = np.random.default_rng(seed)
    port, ref = metrics.Histogram("h", {}), ref_metrics.Histogram("h", {})
    for v in rng.choice([0.1, 3.0, 7.0], int(rng.integers(2, 12))) \
            * rng.choice([1.0, 1.0 + 1e-9], 1):
        port.observe(v)
        ref.observe(v)
    for p in range(0, 101):
        got, want = port.percentile(p), ref.percentile(p)
        assert port.min <= got <= port.max
        assert got == min(max(want, ref.min), ref.max)


def test_module_api_switch_and_sink(tmp_path, monkeypatch):
    """The module-level API on the default registry: the master switch,
    its override, and the JSONL sink; every event it records validates."""
    sink = tmp_path / "events.jsonl"
    monkeypatch.setattr(metrics, "_default",
                        metrics.Registry(enabled=True, sink=str(sink)))
    obs.inc("serve.cache_hits", app="bfs", layout="L")
    obs.observe("serve.query_wall_s", 0.5, app="bfs", layout="L")
    obs.event("serve_batch", app="bfs", layout="L", batch=3,
              distinct_sources=2, width=2, wall_s=0.1)
    with obs.override_enabled(False):
        assert not obs.enabled()
        obs.inc("serve.cache_hits", app="bfs", layout="L")
        obs.event("cache_clear", layout="L")
    assert obs.enabled()
    assert obs.snapshot()["counters"] == {
        "serve.cache_hits{app=bfs,layout=L}": 1}
    lines = [json.loads(x) for x in sink.read_text().splitlines()]
    assert [e["event"] for e in lines] == ["serve_batch"]
    assert obs.events() == lines
    assert all(obs.validate_event(e) == [] for e in lines)
    monkeypatch.setenv(metrics.ENV_ENABLED, "off")
    assert obs.set_enabled() is False
    monkeypatch.setenv(metrics.ENV_ENABLED, "1")
    assert obs.set_enabled() is True
    metrics.registry().close()


def test_event_schema_matches_reference():
    assert obs.EVENT_SCHEMA == ref_schema.EVENT_SCHEMA
    recs = [{"event": "serve_query", "ts": 1.0, "app": "bfs", "layout": "L",
             "cached": True, "wall_s": 0},
            {"event": "serve_query", "ts": 1.0, "app": "bfs",
             "cached": 1, "wall_s": True},
            {"event": "nope", "ts": 1.0}, {"ts": 2.0},
            {"event": "epoch_swap", "old": "a", "new": "b", "epoch": 1,
             "delta": False, "changed_parts": 0, "evicted": 0,
             "migrated": 0}]
    for rec in recs:
        assert obs.validate_event(rec) == ref_schema.validate_event(rec)


# ---------------------------------------------------------------- cache

PARAMS = [{"source": 3}, {"source": np.int64(3), "max_iters": 5},
          {"seeds": [1, 2], "eps": np.float32(0.5)},
          {"seeds": np.arange(3), "b": (1, 2)}, {"x": {"unhashable": 1}},
          {}]


@pytest.mark.parametrize("params", PARAMS, ids=range(len(PARAMS)))
def test_keys_match_reference(params):
    assert cache.canon_params(params) == ref_cache.canon_params(params)
    assert cache.result_key("T", "bfs", params) == \
        ref_cache.result_key("T", "bfs", params)
    assert cache.semantic_key("T", "sssp", params, 7) == \
        ref_cache.semantic_key("T", "sssp", params, 7)
    if ref_cache.canon_params(params) is not None:
        assert cache.semantic_prefix("T", "sssp", params) == \
            ref_cache.semantic_prefix("T", "sssp", params)


def _ops(rng, n=300):
    keys = [f"res|T|bfs|{i}" for i in range(12)] + [None]
    for _ in range(n):
        op = rng.choice(["get", "put", "put", "evict", "prefix"])
        key = keys[int(rng.integers(len(keys)))]
        yield op, key


@pytest.mark.parametrize("seed", range(3))
def test_memory_lru_matches_reference(seed):
    port, ref = cache.MemoryLRU(5), ref_cache.MemoryLRU(5)
    for op, key in _ops(np.random.default_rng(seed)):
        if op == "get":
            assert (port.get(key) is None) == (ref.get(key) is None)
        elif op == "put":
            port.put(key, {"v": key})
            ref.put(key, {"v": key})
        elif op == "evict":
            assert port.evict(key) == ref.evict(key)
        else:
            assert cache.evict_prefix(port, "res|T|bfs|1") == \
                ref_cache.evict_prefix(ref, "res|T|bfs|1")
        assert port.keys() == ref.keys()
    assert port.stats() == ref.stats()


def _entry(rng):
    return {"level": rng.integers(-1, 9, 50).astype(np.int32),
            "dist": rng.random(50).astype(np.float32),
            "meta": {"iters": 4, "fills": {"dist": math.inf}},
            "nested": {"parts": np.arange(3, dtype=np.int32), "tag": "x"},
            "stats": [1, 2]}


def _same_entry(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and np.array_equal(v, b[k])
        elif isinstance(v, dict):
            _same_entry(v, b[k])
        else:
            assert v == b[k]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_disk_cache_round_trip_across_packages(tmp_path, writer):
    """One package writes a disk cache (puts past capacity, an eviction),
    the other opens the directory and reads the same entries, bit-exact;
    reopening a log of dead records compacts it."""
    make = {"port": cache.DiskCache, "reference": ref_cache.DiskCache}
    other = "reference" if writer == "port" else "port"
    rng = np.random.default_rng(4)
    w = make[writer](tmp_path, capacity=3)
    entries = {f"res|T|bfs|{i}": _entry(rng) for i in range(5)}
    for key, value in entries.items():
        w.put(key, value)
    assert w.evict("res|T|bfs|3")
    r = make[other](tmp_path, capacity=3)
    assert r.keys() == w.keys() == ["res|T|bfs|2", "res|T|bfs|4"]
    for key in r.keys():
        _same_entry(r.get(key), w.get(key))
        _same_entry(r.get(key), {k: (list(v) if k == "stats" else v)
                                 for k, v in entries[key].items()})
    for i in range(40):
        r.put(f"res|T|x|{i}", {"v": np.arange(i)})
    r.clear()
    r.put("res|T|y|0", {"v": np.arange(2)})
    again = make[writer](tmp_path, capacity=3)
    assert again.keys() == ["res|T|y|0"]
    assert len((tmp_path / "index.jsonl").read_text().splitlines()) == 1
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == \
        [again._fname("res|T|y|0")]


@pytest.fixture(scope="module")
def layouts():
    g = rmat(8, 8, seed=3, weighted=True)
    out = {}
    for name, graph in (("directed", g), ("symmetric", symmetrize(g))):
        L = build_layout(graph, k=8, edge_tile=64, msg_tile=32)
        out[name] = (L, layout_from_reference(L))
    return out


@pytest.mark.parametrize("name", ["directed", "symmetric"])
def test_layout_tags_match_reference(layouts, name):
    L, TL = layouts[name]
    assert cache.layout_tag(TL) == ref_cache.layout_tag(L)
    assert cache.partition_tags(TL) == ref_cache.partition_tags(L)
    for weights in (False, True):
        assert cache.layout_is_symmetric(TL, weights=weights) == \
            ref_cache.layout_is_symmetric(L, weights=weights)
    assert cache.layout_is_symmetric(TL, weights=False) == \
        (name == "symmetric")


def test_semantic_cache_matches_reference(layouts):
    """Landmarks stored by partition in one backend each: lookups, the
    best landmark for every vertex, and expansion agree."""
    L, _ = layouts["symmetric"]
    rng = np.random.default_rng(6)
    port = cache.SemanticCache(cache.MemoryLRU(64), "T", L.k, L.q, L.n_pad)
    ref = ref_cache.SemanticCache(ref_cache.MemoryLRU(64), "T", L.k, L.q,
                                  L.n_pad)
    for lm in (3, 40, 200):
        dist = np.full(L.n_pad, np.inf, np.float32)
        reach = rng.random(L.n_pad) < 0.4
        dist[reach] = rng.random(int(reach.sum())).astype(np.float32) * 9
        for sc in (port, ref):
            sc.put_state("sssp", {}, lm, {"dist": dist}, np.isfinite(dist),
                         {"dist": float("inf")}, iters=7)
    assert sorted(port.landmarks("sssp", {})) == \
        sorted(ref.landmarks("sssp", {})) == [3, 40, 200]
    for v in range(0, L.n, 7):
        got = port.best_landmark("sssp", {}, v, "dist", max_distance=5.0)
        want = ref.best_landmark("sssp", {}, v, "dist", max_distance=5.0)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] == want[0] and got[2] == want[2]
            assert np.array_equal(port.expand(got[1], "dist", np.inf),
                                  ref.expand(want[1], "dist", np.inf))


def test_cache_warmer_matches_reference(layouts):
    """Hot sources become jobs at the threshold, a budget drains them, and
    a source that already has a landmark is not warmed again."""
    L, _ = layouts["symmetric"]
    runs = {"port": [], "reference": []}
    for name, mod in (("port", cache), ("reference", ref_cache)):
        sc = mod.SemanticCache(mod.MemoryLRU(64), "T", L.k, L.q, L.n_pad)
        sc.put_state("bfs", {}, 9, {"level": np.zeros(L.n_pad, np.int32)},
                     np.ones(L.n_pad, bool), {"level": -1.0}, iters=1)
        warmer = mod.CacheWarmer(sc, threshold=2, budget=2)
        for s in (1, 2, 1, 9, 9, 3, 2, 1):
            warmer.note_query("bfs", {}, s)
        warmer.scan()
        runs[name].append(list(warmer.pending))
        warmer.drain(lambda app, extra, s: runs[name].append((app, s)))
        runs[name].append(warmer.frequencies("bfs", {}))
    assert runs["port"] == runs["reference"]

"""Metrics registry: counters, gauges, and log-bucketed histograms.

A copy of :mod:`repro.obs.metrics` (host Python, no JAX in it) with one
intended difference: :meth:`Histogram.percentile` clamps its estimate to
the observed ``[min, max]``.  The reference's linear interpolation between
two clamped bucket representatives can land one ulp outside that range
(``2.9999999999999996`` below a minimum of ``3.0``); here it cannot.

Every metric lives in a :class:`Registry` keyed on ``(kind, name,
labels)``.  The registry is thread-safe (the serving tier records from
scheduler threads) and near-free when disabled: each recording entry
point is a single attribute test before any allocation happens, so a
``REPRO_OBS=0`` process pays one branch per call site and never creates
a metric object.

Histograms are log-bucketed: bucket ``i`` covers
``(LO * GROWTH**(i-1), LO * GROWTH**i]`` so the memory cost is a small
dict regardless of sample count and any quantile estimate is within one
bucket's relative width (``GROWTH``) of the true order statistic —
tight enough for latency percentiles, unbeatable for the price.

The registry also carries two streams the plain metrics cannot express:

* **events** — schema'd dicts (:mod:`repro_torch.obs.schema`) appended to a
  bounded in-memory buffer and, when ``REPRO_OBS_SINK`` names a path,
  streamed to it as JSON lines;
* **cost samples** — ``(mode, size, wall_s)`` tuples recorded per engine
  step, the raw table an online Eq. 1 cost-model calibration fits.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from collections import deque

ENV_ENABLED = "REPRO_OBS"
ENV_SINK = "REPRO_OBS_SINK"
_FALSY = ("0", "false", "off", "no")


def _env_enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1").strip().lower() not in _FALSY


def _env_sink():
    return os.environ.get(ENV_SINK) or None


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic (between resets) event count."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, v=1):
        with self._lock:
            self.value += v

    def reset(self):
        with self._lock:
            self.value = 0


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self.value = v

    def inc(self, v=1):
        with self._lock:
            self.value += v

    def reset(self):
        with self._lock:
            self.value = 0.0


class Histogram:
    """Log-bucketed histogram with percentile estimation.

    Bucket 0 holds values ``<= LO``; bucket ``i >= 1`` covers
    ``(LO * GROWTH**(i-1), LO * GROWTH**i]``.  ``percentile`` follows
    numpy's default linear interpolation over order statistics, with
    each order statistic represented by its bucket's geometric midpoint
    (clamped to the observed min/max), so estimates land within one
    bucket width of ``numpy.percentile`` on the raw data, and never outside
    ``[min, max]``.
    """

    GROWTH = 2.0 ** 0.25
    LO = 1e-9

    __slots__ = ("name", "labels", "n", "sum", "min", "max", "_counts",
                 "_lock", "_log_growth")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._counts = {}                     # bucket index -> count
        self._lock = threading.Lock()
        self._log_growth = math.log(self.GROWTH)

    def _bucket(self, v: float) -> int:
        if v <= self.LO:
            return 0
        return 1 + int(math.floor(math.log(v / self.LO) / self._log_growth
                                  + 1e-12))

    def bucket_bounds(self, idx: int) -> tuple:
        """(lo, hi] bounds of bucket ``idx``."""
        if idx <= 0:
            return (0.0, self.LO)
        return (self.LO * self.GROWTH ** (idx - 1),
                self.LO * self.GROWTH ** idx)

    def observe(self, v):
        v = float(v)
        # _bucket, min() and max() written out: an engine observes once
        # an iteration
        b = 0 if v <= self.LO else 1 + int(math.floor(
            math.log(v / self.LO) / self._log_growth + 1e-12))
        with self._lock:
            self.n += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._counts[b] = self._counts.get(b, 0) + 1

    def reset(self):
        with self._lock:
            self.n = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf
            self._counts.clear()

    # -- quantiles -----------------------------------------------------
    def _rep(self, idx: int) -> float:
        lo, hi = self.bucket_bounds(idx)
        rep = math.sqrt(hi * max(lo, self.LO * 1e-3)) if idx > 0 else 0.0
        return min(max(rep, self.min), self.max)

    def _order_stat_bucket(self, k: int) -> int:
        """Bucket index containing the k-th (0-based) order statistic."""
        cum = 0
        for idx in sorted(self._counts):
            cum += self._counts[idx]
            if cum > k:
                return idx
        return max(self._counts) if self._counts else 0

    def percentile(self, p: float) -> float:
        with self._lock:
            if self.n == 0:
                return math.nan
            if self.n == 1:
                return self.min
            target = (p / 100.0) * (self.n - 1)
            k = int(math.floor(target))
            frac = target - k
            lo = self._rep(self._order_stat_bucket(k))
            if frac <= 0 or k + 1 >= self.n:
                return lo
            hi = self._rep(self._order_stat_bucket(k + 1))
            # clamped: the interpolation may round one ulp past [min, max]
            return min(max(lo * (1.0 - frac) + hi * frac, self.min),
                       self.max)

    @property
    def p50(self):
        return self.percentile(50)

    @property
    def p95(self):
        return self.percentile(95)

    @property
    def p99(self):
        return self.percentile(99)

    def summary(self) -> dict:
        with self._lock:
            n, s = self.n, self.sum
            mn = self.min if n else None
            mx = self.max if n else None
        out = {"count": n, "sum": s, "min": mn, "max": mx}
        if n:
            out.update(p50=self.percentile(50), p95=self.percentile(95),
                       p99=self.percentile(99))
        return out

    def cumulative_buckets(self):
        """(upper_bound, cumulative_count) pairs, Prometheus-style."""
        with self._lock:
            items = sorted(self._counts.items())
        cum, out = 0, []
        for idx, c in items:
            cum += c
            out.append((self.bucket_bounds(idx)[1], cum))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """One process-wide home for metrics, events, and cost samples.

    ``enabled`` resolves from ``REPRO_OBS`` (anything but
    0/false/off/no enables; the default is ON).  When disabled, every
    recording method returns after one attribute test — no metric
    objects, no events, no sink writes.
    """

    def __init__(self, enabled=None, sink=None, max_events: int = 65536):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self._metrics = {}            # (kind, name, labelkey) -> metric
        # (kind, name, *labels.items()) as called -> metric: a hot caller
        # (one engine iteration) skips the sorted label key
        self._by_call = {}
        self._events = deque(maxlen=max_events)
        self._cost = []               # (mode, size, wall_s, extra) tuples
        self._lock = threading.Lock()
        self._sink_path = _env_sink() if sink is None else sink
        self._sink = None             # export.JsonlSink, opened on first use
        self._sink_lock = threading.Lock()

    # -- metric construction -------------------------------------------
    def _get(self, kind: str, name: str, labels: dict):
        call = (kind, name, *labels.items())
        try:
            m = self._by_call.get(call)
        except TypeError:             # an unhashable label value
            call = m = None
        if m is not None:
            return m
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = _KINDS[kind](name, labels)
                    self._metrics[key] = m
        if call is not None:
            self._by_call[call] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # -- recording (no-ops when disabled) ------------------------------
    def inc(self, name: str, v=1, **labels):
        if not self.enabled:
            return
        self.counter(name, **labels).inc(v)

    def set_gauge(self, name: str, v, **labels):
        if not self.enabled:
            return
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v, **labels):
        if not self.enabled:
            return
        self.histogram(name, **labels).observe(v)

    def event(self, event: str, **fields):
        if not self.enabled:
            return
        rec = {"event": event, "ts": time.time()}
        rec.update(fields)
        self._emit(rec)

    def _emit(self, rec: dict):
        """Buffer and stream one event record, ``event`` and ``ts`` set."""
        self._events.append(rec)
        self._sink_write(rec)

    def cost_sample(self, mode: str, size, wall_s, **extra):
        """One (partition mode, work size, wall seconds) step timing —
        the raw material for online Eq. 1 cost-model calibration."""
        if not self.enabled:
            return
        with self._lock:
            self._cost.append((str(mode), int(size), float(wall_s), extra))

    # -- reads ---------------------------------------------------------
    def cost_samples(self, mode=None):
        """``(mode, size, wall_s)`` tuples recorded so far, optionally
        filtered to one partition mode."""
        with self._lock:
            rows = list(self._cost)
        return [(m, s, w) for m, s, w, _ in rows
                if mode is None or m == mode]

    def cost_samples_full(self, mode=None):
        with self._lock:
            rows = list(self._cost)
        return [r for r in rows if mode is None or r[0] == mode]

    def events(self, event=None):
        out = list(self._events)
        if event is not None:
            out = [e for e in out if e.get("event") == event]
        return out

    def metrics(self):
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict:
        """{kind: {"name{k=v,...}": value-or-summary}} for reporting."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, lk), m in self.metrics().items():
            label_s = ",".join(f"{k}={v}" for k, v in lk)
            key = f"{name}{{{label_s}}}" if label_s else name
            if kind == "counter":
                out["counters"][key] = m.value
            elif kind == "gauge":
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out

    # -- lifecycle -----------------------------------------------------
    def reset(self):
        """Drop every metric, event, and cost sample (enabled/sink kept)."""
        with self._lock:
            self._metrics.clear()
            self._by_call.clear()
            self._cost.clear()
        self._events.clear()

    def reset_metric(self, name: str, **labels):
        """Reset every metric series called ``name`` whose labels contain
        the given items (hit-rate segmentation: resetting a layout's
        series must not disturb other layouts')."""
        want = set(_label_key(labels))
        for (kind, n, lk), m in self.metrics().items():
            if n == name and want <= set(lk):
                m.reset()

    def set_sink(self, path):
        """Redirect the streaming JSONL sink (None closes it)."""
        with self._sink_lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            self._sink_path = str(path) if path else None

    def _sink_write(self, rec: dict):
        if self._sink_path is None:
            return
        with self._sink_lock:
            if self._sink_path is None:
                return
            if self._sink is None:
                from .export import JsonlSink    # export imports this module
                self._sink = JsonlSink(self._sink_path)
            self._sink.emit(rec)
            self._sink.flush()

    def close(self):
        self.set_sink(self._sink_path)        # closes the open handle


def _json_default(o):
    for cast in (int, float):
        try:
            return cast(o)
        except (TypeError, ValueError):
            continue
    return str(o)


# ----------------------------------------------------------------------
# process-default registry + module-level convenience API
# ----------------------------------------------------------------------

_default = Registry()


def registry() -> Registry:
    return _default


def enabled() -> bool:
    return _default.enabled


def set_enabled(value=None) -> bool:
    """Force telemetry on/off; ``None`` re-reads ``REPRO_OBS``."""
    _default.enabled = _env_enabled() if value is None else bool(value)
    return _default.enabled


@contextlib.contextmanager
def override_enabled(value: bool):
    """Temporarily force the default registry on/off (tests)."""
    prev = _default.enabled
    _default.enabled = bool(value)
    try:
        yield
    finally:
        _default.enabled = prev


def counter(name: str, **labels) -> Counter:
    return _default.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _default.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _default.histogram(name, **labels)


def inc(name: str, v=1, **labels):
    _default.inc(name, v, **labels)


def set_gauge(name: str, v, **labels):
    _default.set_gauge(name, v, **labels)


def observe(name: str, v, **labels):
    _default.observe(name, v, **labels)


def event(event_name: str, **fields):
    _default.event(event_name, **fields)


def cost_sample(mode: str, size, wall_s, **extra):
    _default.cost_sample(mode, size, wall_s, **extra)


def cost_samples(mode=None):
    return _default.cost_samples(mode)


def events(event_name=None):
    return _default.events(event_name)


def snapshot() -> dict:
    return _default.snapshot()


def reset():
    _default.reset()

"""repro_torch.obs: the telemetry the engines and the serving tier record.

Copies of the reference's :mod:`repro.obs` (a metrics registry of counters,
gauges and log-bucketed histograms with p50/p95/p99, a schema'd event
stream, Eq. 1 cost samples, the JSONL and Prometheus exporters), host Python
only, and its kernel tracing on ``torch.profiler``
(:mod:`repro_torch.obs.tracing`).

``REPRO_OBS``
    Master switch.  Unset or truthy: on (the default).  ``0`` (also
    ``false`` / ``off`` / ``no``) turns every recording entry point into
    one attribute test.  ``set_enabled()`` / ``override_enabled()`` flip it
    at runtime.
``REPRO_OBS_SINK``
    Optional path: every event the default registry records is also
    appended to it as one JSON line (:class:`export.JsonlSink`).

What gets recorded: ``Engine.run`` an ``engine_iter`` event per iteration,
with a step-wall histogram and a cost sample; ``run_batched`` ``batch_iter``
and ``lane_compaction`` events; ``run_fused`` a ``fused_run`` event;
``apply_delta`` a ``delta_apply`` event; the ``GraphQueryServer`` its batch,
query, cache and swap events and counters.  Under :func:`trace` every kernel
wrapper call is a ``ppm.<kernel>.<cuda|plain>`` range.
"""
from __future__ import annotations

import time

from . import export, schema, tracing
from .metrics import (ENV_ENABLED, ENV_SINK, Counter, Gauge, Histogram,
                      Registry, cost_sample, cost_samples, counter, enabled,
                      event, events, gauge, histogram, inc, observe,
                      override_enabled, registry, reset, set_enabled,
                      set_gauge, snapshot)
from .schema import BatchIterStats, EVENT_SCHEMA, IterStats, validate_event
from .tracing import annotation, kernel_scope, trace

__all__ = [
    "export", "schema", "tracing", "ENV_ENABLED", "ENV_SINK",
    "Counter", "Gauge", "Histogram", "Registry",
    "cost_sample", "cost_samples", "counter", "enabled", "event",
    "events", "gauge", "histogram", "inc", "observe", "override_enabled",
    "registry", "reset", "set_enabled", "set_gauge", "snapshot",
    "BatchIterStats", "EVENT_SCHEMA", "IterStats", "validate_event",
    "annotation", "kernel_scope", "trace",
    "record_engine_iter",
]


def record_engine_iter(engine: str, st: IterStats, wire_bytes=None,
                       **extra):
    """Record one engine iteration: JSONL event + step-wall histogram +
    Eq. 1 cost sample.  A no-op when telemetry is disabled; every value
    is host-resident already (no device syncs).  An engine records one
    per iteration, so the event is built here in one dict (the fields of
    ``event("engine_iter", engine=engine, **as_event(st), **extra)``, in
    that order) and handed to the default registry."""
    reg = registry()
    if not reg.enabled:
        return
    rec = {"event": "engine_iter", "ts": time.time(), "engine": engine}
    rec.update(vars(st))                  # schema.as_event(st), uncopied
    if wire_bytes is not None:
        rec["wire_bytes"] = int(wire_bytes)
    rec.update(extra)
    reg._emit(rec)
    reg._get("histogram", "engine.step_wall_s", {
        "engine": engine, "program": st.program or "?",
        "mode": st.mode or "?"}).observe(st.wall_s)
    reg.cost_sample(st.mode or "?", st.e_active, st.wall_s, it=st.it,
                    engine=engine, program=st.program)

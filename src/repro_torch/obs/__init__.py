"""repro_torch.obs: the telemetry the serving tier records into.

Copies of the reference's :mod:`repro.obs` metrics registry (counters,
gauges, log-bucketed histograms with p50/p95/p99, a schema'd event stream
and its optional JSONL sink) and event schema; host Python only.

``REPRO_OBS``
    Master switch.  Unset or truthy: on (the default).  ``0`` (also
    ``false`` / ``off`` / ``no``) turns every recording entry point into
    one attribute test.  ``set_enabled()`` / ``override_enabled()`` flip it
    at runtime.
``REPRO_OBS_SINK``
    Optional path: every event the default registry records is also
    appended to it as one JSON line.

Not ported yet: ``tracing`` (named scopes around kernels), ``export``
(Prometheus and JSONL writers) and the engines' per-iteration telemetry.
"""
from __future__ import annotations

from . import schema
from .metrics import (ENV_ENABLED, ENV_SINK, Counter, Gauge, Histogram,
                      Registry, cost_sample, cost_samples, counter, enabled,
                      event, events, gauge, histogram, inc, observe,
                      override_enabled, registry, reset, set_enabled,
                      set_gauge, snapshot)
from .schema import BatchIterStats, EVENT_SCHEMA, IterStats, validate_event

__all__ = [
    "schema", "ENV_ENABLED", "ENV_SINK",
    "Counter", "Gauge", "Histogram", "Registry",
    "cost_sample", "cost_samples", "counter", "enabled", "event",
    "events", "gauge", "histogram", "inc", "observe", "override_enabled",
    "registry", "reset", "set_enabled", "set_gauge", "snapshot",
    "BatchIterStats", "EVENT_SCHEMA", "IterStats", "validate_event",
]

"""Telemetry schema: the per-iteration stat records and the JSONL event
contract (a copy of :mod:`repro.obs.schema`).

``IterStats`` and ``BatchIterStats`` are the records of
:meth:`repro_torch.core.engine.Engine.run` and
:meth:`~repro_torch.core.engine.Engine.run_batched`, with the fields of
their namesakes, so the tests compare the two engines' records field by
field; ``as_event`` turns one into the dict the JSONL sink ships.

``EVENT_SCHEMA`` is the machine-checkable contract for every event type
the reference emits: per event, the required fields and their types.
Extra fields are always allowed (events are forward-extensible); missing or
mistyped required fields are a schema violation.  The port records every
event of it but ``bench_row`` (benchmarks are not ported).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class IterStats:
    """Per-iteration record of an :meth:`Engine.run` invocation."""
    it: int
    n_active: int
    e_active: int
    dc_parts: int
    sc_parts: int
    dc_bytes: float
    sc_bytes: float
    wall_s: float
    #: effective step mode ('dc' / 'sc' / 'hybrid')
    mode: str = ""
    #: vertex-program name
    program: str = ""


@dataclasses.dataclass
class BatchIterStats:
    """Per-iteration stats of a :meth:`Engine.run_batched` invocation."""
    it: int
    lanes_active: int         # queries still converging this iteration
    n_active: int             # active vertices summed over all lanes
    wall_s: float


def as_event(stats) -> dict:
    """The record's fields as a dict: ``dataclasses.asdict`` of these flat
    records, without its deep copy (an engine records one a step)."""
    return dict(vars(stats))


# ----------------------------------------------------------------------
# event contract
# ----------------------------------------------------------------------

#: every event implicitly carries {"event": str, "ts": float}
EVENT_SCHEMA = {
    "version": 1,
    "events": {
        # one engine iteration (single-device or distributed); dist steps
        # add wire_bytes (analytic all_to_all payload)
        "engine_iter": {
            "required": {"engine": "str", "program": "str", "it": "int",
                         "mode": "str", "n_active": "int",
                         "e_active": "int", "wall_s": "float"},
        },
        # one batched (multi-source) engine step
        "batch_iter": {
            "required": {"engine": "str", "program": "str", "it": "int",
                         "lanes_active": "int", "width": "int",
                         "wall_s": "float"},
        },
        # converged lanes compacted out of a batch (pow2 repack)
        "lane_compaction": {
            "required": {"engine": "str", "program": "str", "it": "int",
                         "lanes_active": "int", "width": "int",
                         "batch": "int"},
        },
        # a fully-jitted fixed-iteration loop (Engine.run_fused)
        "fused_run": {
            "required": {"engine": "str", "program": "str", "iters": "int",
                         "wall_s": "float"},
        },
        # one fused serve-tier batch answered by run_batched
        "serve_batch": {
            "required": {"app": "str", "layout": "str", "batch": "int",
                         "distinct_sources": "int", "width": "int",
                         "wall_s": "float"},
        },
        # one query answered on the single-query path
        "serve_query": {
            "required": {"app": "str", "layout": "str", "cached": "bool",
                         "wall_s": "float"},
        },
        # a fused batch that ran with landmark-seeded initial state
        # (semantic cache hit on at least one lane); saved_iters is the
        # landmark's cold iteration count minus the seeded run's, floored
        # at zero — a proxy for the iterations the seed saved
        "seeded_batch": {
            "required": {"app": "str", "layout": "str", "batch": "int",
                         "seeded": "int", "iters": "int",
                         "saved_iters": "int"},
        },
        # one landmark precomputed by the async cache warmer
        "cache_warm": {
            "required": {"app": "str", "layout": "str", "source": "int",
                         "wall_s": "float"},
        },
        # result/semantic cache dropped (same-layout invalidation escape
        # hatch)
        "cache_clear": {
            "required": {"layout": "str"},
        },
        # server re-pointed at a new resident layout
        "layout_swap": {
            "required": {"old": "str", "new": "str"},
        },
        # apply_delta relayouted a graph delta (dirty partitions only)
        "delta_apply": {
            "required": {"dirty_parts": "int", "k": "int",
                         "inserts": "int", "deletes": "int",
                         "wall_s": "float"},
        },
        # an epoch-tagged layout swap: scoped invalidation accounting
        # (changed_parts = partitions whose content tag changed; evicted /
        # migrated = old-tag cache entries dropped / re-keyed)
        "epoch_swap": {
            "required": {"old": "str", "new": "str", "epoch": "int",
                         "delta": "bool", "changed_parts": "int",
                         "evicted": "int", "migrated": "int"},
        },
        # one benchmark row (per-row timings from benchmarks/*)
        "bench_row": {
            "required": {"kernel": "str", "backend": "str",
                         "wall_s": "float"},
        },
    },
}

#: JSON type tags -> python type tuples accepted by the validator
TYPE_TAGS = {
    "str": (str,),
    "int": (int,),
    "float": (int, float),        # ints are acceptable floats
    "bool": (bool,),
}


def validate_event(rec: dict, schema: dict = None):
    """Return a list of violation strings for one event dict (empty when
    valid).  Unknown event types and missing/mistyped required fields are
    violations; extra fields are not."""
    schema = EVENT_SCHEMA if schema is None else schema
    errs = []
    ev = rec.get("event")
    if not isinstance(ev, str):
        return ["missing/invalid 'event' field"]
    spec = schema["events"].get(ev)
    if spec is None:
        return [f"unknown event type {ev!r}"]
    if not isinstance(rec.get("ts"), (int, float)):
        errs.append(f"{ev}: missing/invalid 'ts'")
    for field, tag in spec["required"].items():
        if field not in rec:
            errs.append(f"{ev}: missing required field {field!r}")
            continue
        ok_types = TYPE_TAGS[tag]
        v = rec[field]
        # bool is an int subclass: reject it where an int/float is asked
        if isinstance(v, bool) and tag in ("int", "float"):
            errs.append(f"{ev}: field {field!r} expected {tag}, got bool")
        elif not isinstance(v, ok_types):
            errs.append(f"{ev}: field {field!r} expected {tag}, "
                        f"got {type(v).__name__}")
    return errs

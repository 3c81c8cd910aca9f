"""Exporters: JSONL event files and Prometheus text snapshots.

Two consumption models, matching how the telemetry is actually read:

* **JSONL events** — one JSON object per line, schema'd by
  :mod:`repro_torch.obs.schema`.  ``write_jsonl`` dumps a registry's
  buffered events; :class:`JsonlSink` streams records as they are produced
  (what ``REPRO_OBS_SINK`` wires the default registry to, flushed per
  event).
* **Prometheus text** — ``prometheus_text`` renders a point-in-time
  snapshot of every counter / gauge / histogram in the exposition
  format, so a scrape endpoint (or a human) can read the serving tier's
  queue depth, hit ratios, and latency percentiles directly.

A copy of :mod:`repro.obs.export` (host Python): on the same registry
content both packages write the same bytes.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from . import metrics as metrics_lib
from .metrics import _json_default

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    items = sorted(labels.items())
    body = ",".join(f'{_LABEL_RE.sub("_", str(k))}="{v}"'
                    for k, v in items)
    return "{" + body + "}"


# ----------------------------------------------------------------------
# JSONL
# ----------------------------------------------------------------------

class JsonlSink:
    """Streaming JSONL writer (context manager)."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = None

    def __enter__(self):
        self._f = open(self.path, "a", encoding="utf-8")
        return self

    def emit(self, rec: dict):
        if self._f is None:
            self._f = open(self.path, "a", encoding="utf-8")
        self._f.write(json.dumps(rec, default=_json_default) + "\n")

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __exit__(self, *exc):
        self.close()
        return False


def write_jsonl(path, registry=None) -> int:
    """Dump a registry's buffered events to ``path``; returns the count."""
    registry = registry or metrics_lib.registry()
    evs = registry.events()
    with JsonlSink(path) as sink:
        for e in evs:
            sink.emit(e)
    return len(evs)


def read_jsonl(path):
    """Parse a JSONL event file back into a list of dicts."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ----------------------------------------------------------------------
# Prometheus text exposition
# ----------------------------------------------------------------------

def prometheus_text(registry=None) -> str:
    """Snapshot every metric in the Prometheus text format (0.0.4)."""
    registry = registry or metrics_lib.registry()
    by_name = {}                  # (kind, name) -> [metric, ...]
    for (kind, name, _), m in sorted(registry.metrics().items()):
        by_name.setdefault((kind, name), []).append(m)
    lines = []
    for (kind, name), ms in by_name.items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} "
                     f"{'histogram' if kind == 'histogram' else kind}")
        for m in ms:
            lab = m.labels
            if kind in ("counter", "gauge"):
                lines.append(f"{pname}{_prom_labels(lab)} {m.value}")
                continue
            cum = 0
            for ub, c in m.cumulative_buckets():
                cum = c
                le = dict(lab, le=f"{ub:.6g}")
                lines.append(f"{pname}_bucket{_prom_labels(le)} {c}")
            inf = dict(lab, le="+Inf")
            lines.append(f"{pname}_bucket{_prom_labels(inf)} {max(cum, m.n)}")
            lines.append(f"{pname}_sum{_prom_labels(lab)} {m.sum:.9g}")
            lines.append(f"{pname}_count{_prom_labels(lab)} {m.n}")
    return "\n".join(lines) + ("\n" if lines else "")

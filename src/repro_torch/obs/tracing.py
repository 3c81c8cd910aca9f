"""Kernel and phase tracing on ``torch.profiler``.

Counterpart of :mod:`repro.obs.tracing`.  ``kernel_scope`` is what the
kernel wrappers of :mod:`repro_torch.kernels.ops` enter around their
bodies, named ``ppm.<kernel>.<cuda|plain>``: under a :func:`trace` capture
the scatter / gather / fold phases show up as named host ranges, and the
card's kernel records fall inside their time windows.

The reference's ``jax.named_scope`` adds trace-time metadata only and costs
nothing at run time.  ``torch.profiler.record_function`` costs microseconds
a call on the host even when no profiler runs, so here a scope is entered
only while a profiler is recording and telemetry is on; otherwise
``kernel_scope`` and ``annotation`` return one shared null context, for the
price of two flag tests.

``annotation`` is the host-side counterpart: wrap a host region (a
scheduler tick, a drain) so it is attributable in the same profile.  (On a
card the ranges are the profiler's own, not NVTX ranges: ``torch.cuda.nvtx``
raises on a build without CUDA.)
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from . import metrics

_NULL = contextlib.nullcontext()


def _scope(name: str):
    if not (metrics.enabled() and torch.autograd._profiler_enabled()):
        return _NULL
    return torch.profiler.record_function(name)


def kernel_scope(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records
    and telemetry is on, else a no-op context."""
    return _scope(name)


def annotation(name: str):
    """A host-side profiler range, under the same conditions as
    :func:`kernel_scope`."""
    return _scope(name)


@contextlib.contextmanager
def trace(path):
    """Capture a profiled region into the Chrome trace file ``path``: wrap
    one engine iteration to attribute its kernels::

        with obs.trace("ppm-trace.json"):
            engine.run(state, frontier, max_iters=1, until_empty=False)

    The capture records the host, and the card's kernels when torch sees a
    CUDA device.  Runs regardless of ``REPRO_OBS`` (an explicit capture
    request), though the ``ppm.*`` scopes need telemetry on."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))

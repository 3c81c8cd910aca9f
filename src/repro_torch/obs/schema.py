"""Per-iteration stat records of :meth:`repro_torch.core.engine.Engine.run`
and :meth:`~repro_torch.core.engine.Engine.run_batched`.

``IterStats`` and ``BatchIterStats`` have the fields of their namesakes in
:mod:`repro.obs.schema`, so the tests compare the two engines' records field
by field.  The rest of the reference's telemetry (events, sinks, histograms)
is not ported yet.
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

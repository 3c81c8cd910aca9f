"""The GPOP user API (paper §4.1), adapted to tensor semantics.

The paper steers applications through four scalar callbacks plus an optional
weight hook.  Here each callback is vectorized over the (padded) vertex space;
the engine applies the activity masks, so user code never sees parallelism,
partitioning, or communication — the same contract as the paper:

  scatter_fn(state)                 ≙ scatterFunc(node)    value sent to out-neighbors
  init_fn(state, it)                ≙ initFunc(node)       selective frontier continuity
  apply_fn(state, acc, touched, it) ≙ gatherFunc(val,node) fold result -> update + activate
  filter_fn(state, it)              ≙ filterFunc(node)     final frontier filtering
  apply_weight(vals, w)             ≙ applyWeight(val,wt)

``state`` is a dict of per-vertex tensors with leading dim ``n_pad``, all on
the engine's device.  ``apply_weight`` must preserve the monoid identity
(identity ∘ w = identity).  The CUDA fused DC kernel knows one edge function,
:func:`repro_torch.kernels.fused_step.add_weight` (``vals + w``); a program
with any other ``apply_weight`` runs on the CPU only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import monoid as monoid_lib


@dataclasses.dataclass
class VertexProgram:
    name: str
    monoid: monoid_lib.Monoid
    scatter_fn: Callable                      # (state) -> msgs[n_pad]
    apply_fn: Callable                        # (state, acc, touched, it) -> (state, activated)
    init_fn: Optional[Callable] = None        # (state, it) -> (state, keep)
    filter_fn: Optional[Callable] = None      # (state, it) -> (state, keep)
    apply_weight: Optional[Callable] = None   # (vals, w) -> vals

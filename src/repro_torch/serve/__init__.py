"""Serving tier: graph-analytics query serving over one resident layout.

:class:`ServeConfig` is the one configuration object of the graph query
server (the reference's fields and defaults); :mod:`repro_torch.serve.cache`
is the cache subsystem behind it (backend protocol, semantic entries, async
warmer), a copy of the reference's.  The reference's LM server (``Server``,
``prefill``, ``decode_step``) is not ported yet.
"""
import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class ServeConfig:
    """Consolidated :class:`GraphQueryServer` configuration.

    Engine / batching:
      backend:       None (the engines' kernels: CUDA on a card, their
                     plain versions on the CPU) or ``"ref"`` (the plain
                     PyTorch versions on any device, the counterpart of the
                     reference's ``ref`` backend).
      mode:          scatter-gather mode ('hybrid' | 'dc' | 'sc').
      max_batch:     max queries fused into one batched run.
      sharded/mesh:  distributed serving (both or neither): a
                     :class:`repro_torch.graph.shard.ShardedLayout` of the
                     resident layout and this rank's
                     :class:`repro_torch.dist.Mesh`.
      wire_bf16 / wire_bitmap: dist-only wire compression toggles.

    Caching (see :mod:`repro_torch.serve.cache` for the key space and the
    invalidation rule):
      cache_size:    backend capacity in entries (result + semantic
                     entries share it).
      cache_backend: a :class:`repro_torch.serve.cache.CacheBackend`
                     instance, a directory path (-> :class:`DiskCache`), or
                     None (-> :class:`MemoryLRU`).
      semantic:      enable the partition-level semantic cache: converged
                     per-partition state is captured as landmarks and
                     misses near a landmark run landmark-seeded.
      capture_landmarks: store every computed batch lane's converged
                     state as a landmark (otherwise only the async
                     warmer creates landmarks).
      seed_max_distance: only seed from a landmark within this distance
                     of the query source (None = any reachable landmark).
      warm_threshold: source frequency at which the async warmer
                     precomputes a landmark.
      warm_budget:   landmark precomputations per scheduler tick.
    """

    backend: Optional[str] = None
    mode: str = "hybrid"
    max_batch: int = 64
    cache_size: int = 128
    sharded: Any = None
    mesh: Any = None
    wire_bf16: bool = False
    wire_bitmap: bool = True
    cache_backend: Any = None
    semantic: bool = True
    capture_landmarks: bool = True
    seed_max_distance: Optional[float] = None
    warm_threshold: int = 3
    warm_budget: int = 1


# ServeConfig must exist before .engine executes (it imports it back
# from this partially-initialized package)
from .cache import (CacheBackend, CacheWarmer, DiskCache, MemoryLRU,  # noqa: E402
                    SemanticCache, make_backend)
from .engine import GraphQuery, GraphQueryServer  # noqa: E402

__all__ = [
    "ServeConfig", "CacheBackend", "CacheWarmer", "DiskCache", "MemoryLRU",
    "SemanticCache", "make_backend", "GraphQuery", "GraphQueryServer",
]

"""Single-Source Shortest Path, Bellman-Ford style (paper Alg. 8).

scatterFunc -> distance;  applyWeight -> val + wt;  gatherFunc -> relax
(min-monoid), activate on improvement;  initFunc -> false.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram
from ..kernels.fused_step import add_weight


def sssp_program() -> VertexProgram:
    def scatter_fn(state):
        return state["dist"]

    def apply_fn(state, acc, touched, it):
        better = touched & (acc < state["dist"])
        dist = torch.where(better, acc, state["dist"])
        return dict(state, dist=dist), better

    return VertexProgram(name="sssp", monoid=M.min_(torch.float32),
                         scatter_fn=scatter_fn, apply_fn=apply_fn,
                         apply_weight=add_weight)


def sssp(layout, source: int, mode: str = "hybrid", max_iters: int = None,
         engine: Engine = None, device="cuda"):
    """Distances from ``source`` as a float32 ``[n]`` NumPy array."""
    if not layout.weighted:
        raise ValueError("SSSP needs an edge-weighted graph")
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    dist = torch.full((n_pad,), float("inf"), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    frontier = np.zeros(n_pad, bool)
    frontier[source] = True
    eng = engine if engine is not None else Engine(
        layout, sssp_program(), mode=mode, device=dev)
    state, _, stats = eng.run({"dist": dist}, frontier,
                              max_iters=max_iters or n_pad)
    return {"dist": state["dist"][:layout.n].cpu().numpy(), "stats": stats}


def sssp_multi(layout, sources, engine: Engine = None, max_iters: int = None,
               dist0=None, frontier0=None, device="cuda"):
    """Batched multi-source SSSP: one :meth:`Engine.run_batched` call relaxes
    ``len(sources)`` queries together, bit-exact with per-source
    :func:`sssp` calls; row ``i`` of the ``[B, n]`` distances belongs to
    ``sources[i]``.  ``engine`` may be a
    :class:`repro_torch.dist.engine.DistEngine`; one built with
    ``wire_bf16=True`` rounds the f32 distances it sends to bf16.

    ``dist0`` and ``frontier0`` (``[B, n_pad]``) warm-start the lanes: the
    relaxation converges to each source's exact distances from any
    ``dist0`` that bounds them from above (with ``dist0[i, sources[i]] =
    0``), provided ``frontier0`` covers every vertex with a finite bound.
    Lanes may mix seeded and cold starts."""
    if not layout.weighted:
        raise ValueError("SSSP needs an edge-weighted graph")
    dev = engine.device if engine is not None else resolve_device(device)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    B, n_pad = len(sources), layout.n_pad
    if dist0 is None:
        dist = torch.full((B, n_pad), float("inf"), dtype=torch.float32,
                          device=dev)
        dist[torch.arange(B, device=dev),
             torch.from_numpy(sources).to(dev)] = 0.0
    elif isinstance(dist0, torch.Tensor):
        dist = dist0.to(dev, torch.float32, copy=True)
    else:
        dist = torch.tensor(np.asarray(dist0, np.float32), device=dev)
    if frontier0 is None:
        frontier = np.zeros((B, n_pad), bool)
        frontier[np.arange(B), sources] = True
    else:
        frontier = frontier0
    eng = engine if engine is not None else Engine(
        layout, sssp_program(), mode="dc", device=dev)
    states, _, stats = eng.run_batched({"dist": dist}, frontier,
                                       max_iters=max_iters or n_pad)
    return {"dist": states["dist"][:, :layout.n].cpu().numpy(),
            "stats": stats}

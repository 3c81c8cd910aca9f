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

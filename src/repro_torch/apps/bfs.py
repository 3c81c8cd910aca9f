"""Breadth-First Search (paper Alg. 5).

scatterFunc -> own id;  initFunc -> false (frontier rebuilt);
gatherFunc -> first-visit parent update (min-monoid: lowest-id parent wins,
a deterministic valid BFS tree);  filterFunc -> true.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram


def bfs_program() -> VertexProgram:
    def scatter_fn(state):
        return state["vid"]

    def apply_fn(state, acc, touched, it):
        unvisited = state["parent"] < 0
        hit = touched & unvisited
        # vertex ids are below 2**31, so the uint32 fold reads as int32
        parent = torch.where(hit, M.as_bits(acc), state["parent"])
        level = torch.where(hit, it + 1, state["level"])
        return dict(state, parent=parent, level=level), hit

    return VertexProgram(name="bfs", monoid=M.min_(torch.uint32),
                         scatter_fn=scatter_fn, apply_fn=apply_fn)


def bfs(layout, source: int, mode: str = "hybrid", bw_ratio: float = 2.0,
        engine: Engine = None, max_iters: int = None, device="cuda"):
    """Levels and a BFS tree from ``source``, as ``[n]`` NumPy arrays."""
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    parent = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    parent[source] = source
    level = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    level[source] = 0
    vid = torch.arange(n_pad, dtype=torch.int32, device=dev).view(torch.uint32)
    frontier = np.zeros(n_pad, bool)
    frontier[source] = True
    eng = engine if engine is not None else Engine(
        layout, bfs_program(), mode=mode, bw_ratio=bw_ratio, device=dev)
    state, _, stats = eng.run({"parent": parent, "level": level, "vid": vid},
                              frontier, max_iters=max_iters or n_pad)
    return {"parent": state["parent"][:layout.n].cpu().numpy(),
            "level": state["level"][:layout.n].cpu().numpy(),
            "stats": stats}


def bfs_multi(layout, sources, engine: Engine = None, max_iters: int = None,
              device="cuda"):
    """Batched multi-source BFS: one :meth:`Engine.run_batched` call answers
    ``len(sources)`` queries, bit-exact with per-source :func:`bfs` calls.
    Row ``i`` of every ``[B, n]`` result array belongs to ``sources[i]``."""
    dev = engine.device if engine is not None else resolve_device(device)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    B, n_pad = len(sources), layout.n_pad
    lanes = torch.arange(B, device=dev)
    src = torch.from_numpy(sources).to(dev)
    parent = torch.full((B, n_pad), -1, dtype=torch.int32, device=dev)
    parent[lanes, src] = src.to(torch.int32)
    level = torch.full((B, n_pad), -1, dtype=torch.int32, device=dev)
    level[lanes, src] = 0
    # one row of ids for every lane; the step's message table is a copy
    vid = torch.arange(n_pad, dtype=torch.int32, device=dev).view(
        torch.uint32).expand(B, n_pad)
    frontier = np.zeros((B, n_pad), bool)
    frontier[np.arange(B), sources] = True
    eng = engine if engine is not None else Engine(
        layout, bfs_program(), mode="dc", device=dev)
    states, _, stats = eng.run_batched(
        {"parent": parent, "level": level, "vid": vid}, frontier,
        max_iters=max_iters or n_pad)
    return {"parent": states["parent"][:, :layout.n].cpu().numpy(),
            "level": states["level"][:, :layout.n].cpu().numpy(),
            "stats": stats}

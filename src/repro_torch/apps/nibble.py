"""Parallel Nibble (paper Alg. 3/4) — seeded random-walk probability mass.

This is the paper's showcase for *selective frontier continuity*:
initFunc halves the vertex's probability and lets it stay active iff the
retained mass is still above the eps*deg threshold, independently of whether
the Gather phase touches it again.

One iteration:  p(v) <- p(v)/2 + sum_{u->v, u active} p(u)/(2 deg(u)),
with the frontier = {v : p(v) >= eps*deg(v)}.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram


def nibble_program(eps: float) -> VertexProgram:
    def scatter_fn(state):
        return torch.where(state["deg"] > 0,
                           state["pr"] / (2.0 * state["deg"]), 0.0)

    def init_fn(state, it):
        pr = state["pr"] * 0.5
        return dict(state, pr=pr), pr >= eps * state["deg"]

    def apply_fn(state, acc, touched, it):
        return dict(state, pr=state["pr"] + acc), torch.ones_like(touched)

    def filter_fn(state, it):
        return state, state["pr"] >= eps * state["deg"]

    return VertexProgram(name="nibble", monoid=M.add(torch.float32),
                         scatter_fn=scatter_fn, apply_fn=apply_fn,
                         init_fn=init_fn, filter_fn=filter_fn)


def nibble(layout, seeds, eps: float = 1e-4, max_iters: int = 100,
           mode: str = "hybrid", engine: Engine = None, device="cuda"):
    """Probability mass per vertex (float32 ``[n]`` NumPy) after at most
    ``max_iters`` iterations from ``seeds``, which share mass 1."""
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    seeds = np.atleast_1d(np.asarray(seeds))
    pr = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    pr[torch.from_numpy(seeds.astype(np.int64)).to(dev)] = 1.0 / len(seeds)
    deg = torch.from_numpy(layout.deg.astype(np.float32)).to(dev)
    frontier = np.zeros(n_pad, bool)
    frontier[seeds] = True
    eng = engine if engine is not None else Engine(
        layout, nibble_program(eps), mode=mode, device=dev)
    state, _, stats = eng.run({"pr": pr, "deg": deg}, frontier,
                              max_iters=max_iters)
    return {"pr": state["pr"][:layout.n].cpu().numpy(), "stats": stats}

"""PageRank (paper Alg. 6).

scatterFunc -> rank/deg;  initFunc -> zero the rank, stay active;
gatherFunc -> accumulate;  filterFunc -> damping.  All vertices stay active
every iteration, so the engine runs the fixed-iteration DC path (paper
§6.2.2: "PageRank always uses DC mode").
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram


def pagerank_program(n: int, damping: float = 0.85) -> VertexProgram:
    base = (1.0 - damping) / n

    def scatter_fn(state):
        return torch.where(state["deg"] > 0, state["pr"] / state["deg"], 0.0)

    def init_fn(state, it):
        return dict(state, pr=torch.zeros_like(state["pr"])), \
            torch.ones(state["pr"].shape, dtype=torch.bool,
                       device=state["pr"].device)

    def apply_fn(state, acc, touched, it):
        return dict(state, pr=state["pr"] + acc), torch.ones_like(touched)

    def filter_fn(state, it):
        return dict(state, pr=base + damping * state["pr"]), \
            torch.ones(state["pr"].shape, dtype=torch.bool,
                       device=state["pr"].device)

    return VertexProgram(name="pagerank", monoid=M.add(torch.float32),
                         scatter_fn=scatter_fn, apply_fn=apply_fn,
                         init_fn=init_fn, filter_fn=filter_fn)


def pagerank(layout, iters: int = 10, damping: float = 0.85,
             mode: str = "dc", fused: bool = True, engine: Engine = None,
             device="cuda", pr0=None):
    """Ranks as a float32 ``[n]`` NumPy array.  ``fused=True`` runs
    :meth:`Engine.run_fused`, ``fused=False`` the host-driven
    :meth:`Engine.run` (either of a
    :class:`repro_torch.dist.engine.DistEngine` too).

    ``pr0=`` is the residual-restart path for dynamic graphs: the previous
    layout's converged ``[n]`` (or ``[n_pad]``) ranks after a small delta.
    The damping contraction shrinks the residual, which a warm start leaves
    small, by ``damping`` a sweep, so the same unique fixpoint is reached
    in fewer iterations than from the uniform start (the uniform value
    stays on the pads of an ``[n]`` start)."""
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    if pr0 is None:
        pr = torch.full((n_pad,), 1.0 / layout.n, dtype=torch.float32,
                        device=dev)
    else:
        warm = np.asarray(pr0, np.float32).reshape(-1)
        start = np.full(n_pad, 1.0 / layout.n, np.float32)
        start[:min(warm.size, n_pad)] = warm[:n_pad]
        pr = torch.from_numpy(start).to(dev)
    deg = torch.from_numpy(layout.deg.astype(np.float32)).to(dev)
    state0 = {"pr": pr, "deg": deg}
    frontier = np.zeros(n_pad, bool)
    frontier[:layout.n] = True
    eng = engine if engine is not None else Engine(
        layout, pagerank_program(layout.n, damping), mode=mode, device=dev)
    if fused:
        state, _ = eng.run_fused(state0, frontier, iters)
        stats = []
    else:
        state, _, stats = eng.run(state0, frontier, max_iters=iters,
                                  until_empty=False)
    return {"pr": state["pr"][:layout.n].cpu().numpy(), "stats": stats}

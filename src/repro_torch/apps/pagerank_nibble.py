"""PageRank-Nibble (paper §4.1 cites it with Nibble as needing selective
frontier continuity; Andersen-Chung-Lang approximate personalized PageRank).

Push-free formulation on PPM: residual r diffuses, solution p accumulates:
  p += alpha * r;   r' = (1-alpha)/2 * (r/deg pushed to neighbors + r kept)
frontier = {v : r(v) >= eps * deg(v)} — selective continuity keeps vertices
with large residual active regardless of incoming updates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram


def pagerank_nibble_program(alpha: float, eps: float) -> VertexProgram:
    def scatter_fn(state):
        # push half of the non-retained residual along out-edges
        share = (1.0 - alpha) * 0.5 * state["r"]
        return torch.where(state["deg"] > 0, share / state["deg"], 0.0)

    def init_fn(state, it):
        p = state["p"] + alpha * state["r"]
        r = (1.0 - alpha) * 0.5 * state["r"]      # lazy half stays local
        keep = r >= eps * state["deg"]
        return dict(state, p=p, r=r), keep

    def apply_fn(state, acc, touched, it):
        r = state["r"] + acc
        return dict(state, r=r), r >= eps * state["deg"]

    def filter_fn(state, it):
        return state, state["r"] >= eps * state["deg"]

    return VertexProgram(name="pagerank_nibble",
                         monoid=M.add(torch.float32),
                         scatter_fn=scatter_fn, apply_fn=apply_fn,
                         init_fn=init_fn, filter_fn=filter_fn)


def pagerank_nibble(layout, seeds, alpha: float = 0.15, eps: float = 1e-5,
                    max_iters: int = 200, mode: str = "hybrid",
                    engine: Engine = None, device="cuda"):
    """Approximate personalized PageRank of ``seeds``: ``ppr`` and the
    ``residual`` left, float32 ``[n]`` NumPy."""
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    seeds = np.atleast_1d(np.asarray(seeds))
    r = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    r[torch.from_numpy(seeds.astype(np.int64)).to(dev)] = 1.0 / len(seeds)
    state = {"p": torch.zeros(n_pad, dtype=torch.float32, device=dev),
             "r": r,
             "deg": torch.from_numpy(layout.deg.astype(np.float32)).to(dev)}
    frontier = np.zeros(n_pad, bool)
    frontier[seeds] = True
    eng = engine if engine is not None else Engine(
        layout, pagerank_nibble_program(alpha, eps), mode=mode, device=dev)
    state, _, stats = eng.run(state, frontier, max_iters=max_iters)
    return {"ppr": state["p"][:layout.n].cpu().numpy(),
            "residual": state["r"][:layout.n].cpu().numpy(), "stats": stats}

"""Heat-Kernel PageRank (paper §4.1 cites it as a selective-continuity
application, after Shun et al. [29]).

hkpr(v) = sum_k e^{-t} t^k / k! * P^k(seed)(v), truncated at K terms.
Implemented as K diffusion iterations where the iteration index drives the
coefficient — showcasing the ``it`` argument of the GPOP API and initFunc's
selective continuity (vertices keep diffusing while their residual mass is
above eps, independent of incoming updates).

State: sol (accumulated solution), res (residual mass being diffused).
Iteration k:  sol += res * (weight of staying);  res' = P^T res * t/(k+1).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram


def heat_kernel_program(t: float, eps: float) -> VertexProgram:
    def scatter_fn(state):
        return torch.where(state["deg"] > 0, state["res"] / state["deg"], 0.0)

    def init_fn(state, it):
        # bank the local coefficient share, keep diffusing if mass remains
        sol = state["sol"] + state["res"]
        res = torch.zeros_like(state["res"])
        return dict(state, sol=sol, res=res), \
            torch.zeros(state["res"].shape, dtype=torch.bool,
                        device=state["res"].device)

    def apply_fn(state, acc, touched, it):
        # the engine passes the iteration as a Python int
        k = float(it)
        res = state["res"] + acc * (t / (k + 1.0))
        return dict(state, res=res), res > eps * state["deg"]

    return VertexProgram(name="heat_kernel", monoid=M.add(torch.float32),
                         scatter_fn=scatter_fn, apply_fn=apply_fn,
                         init_fn=init_fn)


def heat_kernel_pr(layout, seeds, t: float = 5.0, eps: float = 1e-5,
                   max_terms: int = 30, mode: str = "hybrid",
                   engine: Engine = None, device="cuda"):
    """Heat-kernel PageRank (float32 ``[n]`` NumPy) of ``seeds``, truncated
    at ``max_terms`` terms."""
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    seeds = np.atleast_1d(np.asarray(seeds))
    res = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    res[torch.from_numpy(seeds.astype(np.int64)).to(dev)] = 1.0 / len(seeds)
    state = {"sol": torch.zeros(n_pad, dtype=torch.float32, device=dev),
             "res": res,
             "deg": torch.from_numpy(layout.deg.astype(np.float32)).to(dev)}
    frontier = np.zeros(n_pad, bool)
    frontier[seeds] = True
    eng = engine if engine is not None else Engine(
        layout, heat_kernel_program(t, eps), mode=mode, device=dev)
    state, _, stats = eng.run(state, frontier, max_iters=max_terms)
    # sol accumulated sum_k t^k/k! P^k; normalize by e^{-t}
    sol = (state["sol"] + state["res"])[:layout.n].cpu().numpy()
    return {"hkpr": sol * math.exp(-t), "stats": stats}

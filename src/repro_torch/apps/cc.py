"""Connected components via label propagation (paper Alg. 7, §5).

labels start as vertex ids; scatterFunc -> label; gatherFunc (compLabel) ->
keep the minimum label, activate on change.  On symmetrized graphs this
converges to weakly-connected components.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram


def cc_program() -> VertexProgram:
    def scatter_fn(state):
        return state["label"]

    def apply_fn(state, acc, touched, it):
        better = touched & (M.widen(acc) < M.widen(state["label"]))
        label = M.where(better, acc, state["label"])
        return dict(state, label=label), better

    return VertexProgram(name="cc", monoid=M.min_(torch.uint32),
                         scatter_fn=scatter_fn, apply_fn=apply_fn)


def connected_components(layout, mode: str = "hybrid",
                         engine: Engine = None, device="cuda"):
    """``uint32`` label per vertex (``[n]`` NumPy): the least vertex id of
    its component on a symmetrized graph."""
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    label = torch.arange(n_pad, dtype=torch.int32,
                         device=dev).view(torch.uint32)
    frontier = np.zeros(n_pad, bool)
    frontier[:layout.n] = True
    eng = engine if engine is not None else Engine(
        layout, cc_program(), mode=mode, device=dev)
    state, _, stats = eng.run({"label": label}, frontier, max_iters=n_pad)
    return {"label": state["label"][:layout.n].cpu().numpy(), "stats": stats}

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
from ..graph.delta import DeltaBuffer


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
                         engine: Engine = None, device="cuda",
                         resume_labels=None, touched=None):
    """``uint32`` label per vertex (``[n]`` NumPy): the least vertex id of
    its component on a symmetrized graph.

    ``resume_labels=`` / ``touched=`` is the incremental path after an
    insertion-only graph delta: the old converged ``[n]`` labels resume
    with the delta-touched vertices (``DeltaBuffer.touched()``, or the
    buffer itself) as the initial frontier, bit-identical to a cold run on
    the new layout (:meth:`Engine.run`).  Deletions can split components,
    which would need labels to rise: they raise ``ValueError``."""
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    eng = engine if engine is not None else Engine(
        layout, cc_program(), mode=mode, device=dev)
    if (resume_labels is None) != (touched is None):
        raise ValueError("resume_labels= and touched= go together")
    if resume_labels is not None:
        label = np.arange(n_pad, dtype=np.uint32)    # pads keep their ids
        label[:layout.n] = np.asarray(resume_labels, np.uint32)[:layout.n]
        if isinstance(touched, DeltaBuffer):
            if touched.num_deletes:
                raise ValueError(
                    "connected_components(resume_labels=) is exact only "
                    "for insertion-only deltas; deletions can split "
                    "components (labels would need to rise): run cold "
                    "on the new layout instead")
            touched = touched.touched()
        t = np.asarray(touched, bool).reshape(-1)    # [n] or [n_pad]
        frontier = np.zeros(n_pad, bool)
        frontier[:min(t.size, n_pad)] = t[:n_pad]
        frontier[layout.n:] = False
        resume = {"label": torch.from_numpy(label.view(np.int32)).to(
            dev).view(torch.uint32)}
        state, _, stats = eng.run(resume_from=resume, touched=frontier,
                                  max_iters=n_pad)
    else:
        label = torch.arange(n_pad, dtype=torch.int32,
                             device=dev).view(torch.uint32)
        frontier = np.zeros(n_pad, bool)
        frontier[:layout.n] = True
        state, _, stats = eng.run({"label": label}, frontier,
                                  max_iters=n_pad)
    return {"label": state["label"][:layout.n].cpu().numpy(), "stats": stats}

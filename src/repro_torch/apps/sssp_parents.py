"""SSSP with parent tracking via the packed (distance, parent) min-monoid.

The paper's Alg. 8 tracks distances only; production SSSP wants the
shortest-path tree.  A lexicographic 8-byte word, (f32 distance bits << 32)
| parent id, keeps the whole fold a pure ``min``, so the lock-free gather
contract is untouched.  The words are ``int64`` here
(:func:`repro_torch.core.monoid.min_with_payload`); torch needs no x64 mode.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..core.engine import Engine, resolve_device
from ..core.program import VertexProgram
from ..kernels.fused_step import add_weight_to_key


def sssp_parents_program() -> VertexProgram:
    mono = M.min_with_payload()

    def scatter_fn(state):
        # message key = my distance (weight added en route), payload = my id
        return M.pack_key_payload(state["dist"], state["vid"])

    def apply_fn(state, acc, touched, it):
        key, parent = M.unpack_key_payload(acc)
        better = touched & (key < state["dist"])
        dist = torch.where(better, key, state["dist"])
        par = torch.where(better, M.as_bits(parent), state["parent"])
        return dict(state, dist=dist, parent=par), better

    return VertexProgram(name="sssp_parents", monoid=mono,
                         scatter_fn=scatter_fn, apply_fn=apply_fn,
                         apply_weight=add_weight_to_key)


def _vids(n_pad: int, device) -> torch.Tensor:
    return torch.arange(n_pad, dtype=torch.int32,
                        device=device).view(torch.uint32)


def sssp_with_parents(layout, source: int, mode: str = "hybrid",
                      engine: Engine = None, max_iters: int = None,
                      device="cuda"):
    """Distances (float32 ``[n]``) and a shortest-path tree (int32 ``[n]``
    parents, ``-1`` unreached, the source its own parent) from ``source``."""
    if not layout.weighted:
        raise ValueError("SSSP with parents needs an edge-weighted graph")
    dev = engine.device if engine is not None else resolve_device(device)
    n_pad = layout.n_pad
    dist = torch.full((n_pad,), float("inf"), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    parent = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    parent[source] = source
    frontier = np.zeros(n_pad, bool)
    frontier[source] = True
    eng = engine if engine is not None else Engine(
        layout, sssp_parents_program(), mode=mode, device=dev)
    state, _, stats = eng.run(
        {"dist": dist, "parent": parent, "vid": _vids(n_pad, dev)}, frontier,
        max_iters=max_iters or n_pad)
    return {"dist": state["dist"][:layout.n].cpu().numpy(),
            "parent": state["parent"][:layout.n].cpu().numpy(),
            "stats": stats}


def sssp_parents_multi(layout, sources, engine: Engine = None,
                       max_iters: int = None, device="cuda"):
    """Batched multi-source SSSP with parent tracking: one
    :meth:`Engine.run_batched` call, bit-exact with per-source
    :func:`sssp_with_parents` calls.  Row ``i`` of the ``[B, n]`` results
    belongs to ``sources[i]``.  A :class:`repro_torch.dist.engine.DistEngine`
    works as ``engine`` too; its bf16 wire never engages for this monoid
    (int64 words), so the result stays exact."""
    if not layout.weighted:
        raise ValueError("SSSP with parents needs an edge-weighted graph")
    dev = engine.device if engine is not None else resolve_device(device)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    B, n_pad = len(sources), layout.n_pad
    lanes = torch.arange(B, device=dev)
    src = torch.from_numpy(sources).to(dev)
    dist = torch.full((B, n_pad), float("inf"), dtype=torch.float32,
                      device=dev)
    dist[lanes, src] = 0.0
    parent = torch.full((B, n_pad), -1, dtype=torch.int32, device=dev)
    parent[lanes, src] = src.to(torch.int32)
    frontier = np.zeros((B, n_pad), bool)
    frontier[np.arange(B), sources] = True
    eng = engine if engine is not None else Engine(
        layout, sssp_parents_program(), mode="dc", device=dev)
    states, _, stats = eng.run_batched(
        {"dist": dist, "parent": parent,
         "vid": _vids(n_pad, dev).expand(B, n_pad)}, frontier,
        max_iters=max_iters or n_pad)
    return {"dist": states["dist"][:, :layout.n].cpu().numpy(),
            "parent": states["parent"][:, :layout.n].cpu().numpy(),
            "stats": stats}

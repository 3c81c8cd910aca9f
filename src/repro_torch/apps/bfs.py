"""Breadth-First Search (paper Alg. 5).

scatterFunc -> own id;  initFunc -> false (frontier rebuilt);
gatherFunc -> first-visit parent update (min-monoid: lowest-id parent wins,
a deterministic valid BFS tree);  filterFunc -> true.

:func:`bfs_seeded_program` is the warm-startable variant: the stock program
derives levels from the iteration counter (``level = it + 1``), which is
only correct from a cold frontier, so the serving tier's landmark-seeded
queries run a packed lexicographic ``(level, parent)`` min-monoid
relaxation instead, whose cold run is bit-identical to stock BFS and whose
warm run is exact from any upper-bound seed.
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
    Row ``i`` of every ``[B, n]`` result array belongs to ``sources[i]``.
    ``engine`` may also be a :class:`repro_torch.dist.engine.DistEngine`
    over a sharding of this layout (``D*nv == n_pad``: the global vertex
    space is the same), and then the batch advances across the ranks; so
    may the other apps' ``engine``."""
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


# ----------------------------------------------------------------------
# warm-startable BFS (landmark seeding)
# ----------------------------------------------------------------------

#: payload sentinel for "level known (or bounded), parent unknown" seeds:
#: any real parent message with an equal key beats it lexicographically
PARENT_SENTINEL = np.uint32(0xFFFFFFFF)


def bfs_seeded_program() -> VertexProgram:
    """BFS as a packed lexicographic ``(level, parent)`` relaxation.

    State holds one packed ``int64`` word per vertex, ``(f32 level bits <<
    32) | parent`` (:func:`repro_torch.core.monoid.pack_key_payload`;
    unvisited = ``(inf, PARENT_SENTINEL)``).  Scatter sends ``(level + 1,
    own id)`` (the identity for unvisited vertices, so they never pollute
    the fold); apply keeps the packed minimum and activates on any packed
    improvement.

    Cold equivalence with :func:`bfs_program` (bit-exact levels and
    parents): from a cold frontier, a vertex at true level ``t`` first
    receives messages at iteration ``t-1``, all from in-neighbors at level
    ``t-1`` (deeper ones are unvisited and send the identity; shallower ones
    send larger keys that lose the fold), so the packed min is ``(t, least
    id of the level-(t-1) in-neighbors)``: the stock first-visit update.
    Warm correctness: the packed order is a monotone min-monoid, so
    relaxation from any upper-bound initialization converges to the same
    least fixpoint as the cold run (:mod:`repro_torch.serve.cache`)."""
    mono = M.min_with_payload()

    def scatter_fn(state):
        key, _ = M.unpack_key_payload(state["best"])
        msg = M.pack_key_payload(key + 1.0, state["vid"])
        return torch.where(torch.isfinite(key), msg, mono.identity)

    def apply_fn(state, acc, touched, it):
        better = touched & (acc < state["best"])
        best = torch.where(better, acc, state["best"])
        return dict(state, best=best), better

    return VertexProgram(name="bfs_seeded", monoid=mono,
                         scatter_fn=scatter_fn, apply_fn=apply_fn)


def bfs_seeded_pack(level, parent) -> torch.Tensor:
    """Pack int level / parent tensors (``-1`` = unvisited) into the seeded
    program's ``int64`` state."""
    visited = level >= 0
    key = torch.where(visited, level.to(torch.float32), float("inf"))
    payload = torch.where(visited, parent.to(torch.int64) & 0xFFFFFFFF,
                          int(PARENT_SENTINEL))
    return M.pack_key_payload(key, payload)


def bfs_seeded_multi(layout, sources, engine: Engine = None,
                     max_iters: int = None, seeds=None, frontiers=None,
                     seed_levels=None, seed_parents=None, device="cuda"):
    """Batched warm-startable BFS.  Without seeds this is a cold run of
    :func:`bfs_seeded_program`, bit-exact with :func:`bfs_multi`.

    ``seeds`` is an optional ``[B, n_pad]`` array of packed ``(level upper
    bound, parent)`` words (:func:`bfs_seeded_pack`): an ``int64`` tensor,
    or the reference's ``uint64`` array (same bits); lanes may mix seeded
    and cold entries.  ``seed_levels`` / ``seed_parents`` (``[B, n_pad]``
    int, ``-1`` = unvisited / unknown parent) are the unpacked form.
    ``frontiers`` (``[B, n_pad]`` bool) must cover every vertex carrying a
    finite seed so that stale bounds get relaxed; it defaults to the cold
    one-hot sources."""
    dev = engine.device if engine is not None else resolve_device(device)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    B, n_pad = len(sources), layout.n_pad
    src = torch.from_numpy(sources).to(dev)
    if seeds is not None:
        if isinstance(seeds, torch.Tensor):
            best = seeds.to(dev, torch.int64, copy=True)
        else:
            best = torch.from_numpy(np.array(seeds).view(np.int64)).to(dev)
    elif seed_levels is not None:
        best = bfs_seeded_pack(torch.as_tensor(np.asarray(seed_levels),
                                               device=dev),
                               torch.as_tensor(np.asarray(seed_parents),
                                               device=dev))
    else:
        level = torch.full((B, n_pad), -1, dtype=torch.int32, device=dev)
        level[torch.arange(B, device=dev), src] = 0
        best = bfs_seeded_pack(level, src[:, None].expand(B, n_pad))
    vid = torch.arange(n_pad, dtype=torch.int32, device=dev).view(
        torch.uint32).expand(B, n_pad)
    if frontiers is None:
        frontiers = np.zeros((B, n_pad), bool)
        frontiers[np.arange(B), sources] = True
    eng = engine if engine is not None else Engine(
        layout, bfs_seeded_program(), mode="dc", device=dev)
    states, _, stats = eng.run_batched({"best": best, "vid": vid}, frontiers,
                                       max_iters=max_iters or n_pad)
    key, payload = M.unpack_key_payload(states["best"][:, :layout.n])
    visited = torch.isfinite(key)
    level = torch.where(visited, key.to(torch.int32), -1)
    parent = torch.where(visited, M.as_bits(payload), -1)
    return {"parent": parent.cpu().numpy(), "level": level.cpu().numpy(),
            "stats": stats}

"""Vertex-centric and edge-centric baselines: the paper's comparison targets.

Counterpart of :mod:`repro.baselines.vc` in plain PyTorch:

  vc_push   - Ligra-style frontier-driven push (work ~ E_a, random writes;
              the atomic-update pattern is a segment fold here)
  vc_pull   - Ligra-style pull direction (work ~ E every iteration)
  ec_stream - X-Stream-style unordered edge streaming (work ~ E)
  spmv      - GraphMat-style masked sparse-matrix-vector product (work ~ E
              + O(V) frontier handling)

Each provides bfs/pagerank/sssp/cc so a benchmark can compare them with
GPOP on identical inputs.  None of them partition, and none uses the port's
partitioned kernels: the memory-access pattern is the whole point of the
contrast.  The reference's XLA ``segment_min`` / ``segment_sum`` are
``Tensor.scatter_reduce_`` (``amin``) and ``Tensor.index_add_`` over the
edge list; the loops end when the frontier empties.

Every function runs on ``device`` (a CUDA device by default, which must
exist; ``device="cpu"`` for the CPU) and returns NumPy arrays of the
reference's dtypes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.engine import resolve_device
from ..graph.csr import Graph

#: the "unreached" sentinel of the BFS fold, as in the reference
SENTINEL = 2 ** 30


def _prep(g: Graph, device) -> dict:
    dev = resolve_device(device)
    src = np.repeat(np.arange(g.n, dtype=np.int64),
                    g.out_degrees().astype(np.int64))
    return {
        "src": torch.from_numpy(src).to(dev),
        "dst": torch.from_numpy(g.indices.astype(np.int64)).to(dev),
        "w": (torch.from_numpy(np.asarray(g.weights, np.float32)).to(dev)
              if g.weights is not None else None),
        "n": g.n, "device": dev,
        "deg": torch.from_numpy(
            g.out_degrees().astype(np.float32)).to(dev),
    }


def _segment_min(vals, dst, n: int, identity):
    """``segment_min(vals, dst, num_segments=n)`` with ``identity`` in the
    empty segments."""
    acc = torch.full((n,), identity, dtype=vals.dtype, device=vals.device)
    return acc.scatter_reduce_(0, dst, vals, "amin", include_self=True)


# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------

def _bfs_engine(g: Graph, source: int, order: str, device):
    """order: 'push' (frontier mask on src), 'pull'/'ec' (all edges)."""
    E = _prep(g, device)
    n, src, dst = E["n"], E["src"], E["dst"]
    level = torch.full((n,), -1, dtype=torch.int32, device=E["device"])
    level[source] = 0
    active = torch.zeros(n, dtype=torch.bool, device=E["device"])
    active[source] = True
    for it in range(n):
        ls = level[src]
        live = active[src] if order == "push" else ls >= 0
        acc = _segment_min(torch.where(live, ls, SENTINEL), dst, n,
                           SENTINEL)
        active = (acc < SENTINEL) & (level < 0)
        level = torch.where(active, it + 1, level)
        if not bool(active.any()):
            break
    return level.cpu().numpy()


def bfs_push(g, source, device="cuda"):
    return _bfs_engine(g, source, "push", device)


def bfs_pull(g, source, device="cuda"):
    return _bfs_engine(g, source, "pull", device)


def bfs_ec(g, source, device="cuda"):
    return _bfs_engine(g, source, "ec", device)


# ---------------------------------------------------------------------------
# PageRank (SpMV-style: GraphMat)
# ---------------------------------------------------------------------------

def pagerank_spmv(g: Graph, iters: int = 10, damping: float = 0.85,
                  device="cuda"):
    E = _prep(g, device)
    n, src, dst, deg = E["n"], E["src"], E["dst"], E["deg"]
    pr = torch.full((n,), 1.0 / n, dtype=torch.float32, device=E["device"])
    for _ in range(iters):
        contrib = torch.where(deg > 0, pr / deg, 0.0)
        acc = torch.zeros_like(pr).index_add_(0, dst, contrib[src])
        pr = (1 - damping) / n + damping * acc
    return pr.cpu().numpy()


# ---------------------------------------------------------------------------
# SSSP (Bellman-Ford, push)
# ---------------------------------------------------------------------------

def sssp_push(g: Graph, source: int, device="cuda"):
    E = _prep(g, device)
    n, src, dst, w = E["n"], E["src"], E["dst"], E["w"]
    if w is None:
        raise ValueError("sssp_push needs a weighted graph")
    dist = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=E["device"])
    dist[source] = 0.0
    active = torch.zeros(n, dtype=torch.bool, device=E["device"])
    active[source] = True
    for _ in range(n):
        relax = torch.where(active[src], dist[src] + w, float("inf"))
        acc = _segment_min(relax, dst, n, float("inf"))
        active = acc < dist
        dist = torch.where(active, acc, dist)
        if not bool(active.any()):
            break
    return dist.cpu().numpy()


# ---------------------------------------------------------------------------
# Connected components (label propagation over all edges: EC style)
# ---------------------------------------------------------------------------

def cc_ec(g: Graph, device="cuda"):
    """Least-id labels.  The reference keeps ``uint32`` labels; torch has no
    ``scatter_reduce`` for ``uint32``, so they are computed in ``int64``
    (every label is below n) and returned as ``uint32``."""
    E = _prep(g, device)
    n, src, dst = E["n"], E["src"], E["dst"]
    label = torch.arange(n, dtype=torch.int64, device=E["device"])
    for _ in range(n):
        acc = _segment_min(label[src], dst, n, n)
        new = torch.minimum(label, acc)
        changed = bool((new != label).any())
        label = new
        if not changed:
            break
    return label.cpu().numpy().astype(np.uint32)


def timed(fn, *args, repeat: int = 1, **kw):
    """Mean wall seconds of ``repeat`` calls after one warm-up call, and the
    last call's result (each function returns host arrays, so every call
    has finished on the device when it returns)."""
    fn(*args, **kw)
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn(*args, **kw)
    return (time.perf_counter() - t0) / repeat, out

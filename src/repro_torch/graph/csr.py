"""CSR graph container and synthetic graph generators.

A copy of :mod:`repro.graph.csr` (NumPy only), kept here so that the
port imports nothing of the JAX package; the tests hold the two
array-for-array.

GPOP (the paper) stores graphs in CSR/CSC; partitions are index-contiguous
vertex ranges.  This module is the NumPy-side substrate: ingestion,
generators (RMAT as used in the paper's scalability study, uniform random,
and small deterministic graphs for tests), and basic transforms.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed graph in CSR form (out-edges, sorted by source).

    Attributes:
      indptr:  int64[n + 1]  CSR row pointer.
      indices: int32[m]      destination vertex of each out-edge.
      weights: float32[m] | None  edge weights (None = unweighted).
      n:       number of vertices.
    """

    indptr: np.ndarray
    indices: np.ndarray
    weights: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def m(self) -> int:
        return int(self.indptr[-1])

    @property
    def weighted(self) -> bool:
        return self.weights is not None

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n).astype(np.int64)

    def validate(self) -> None:
        assert self.indptr[0] == 0
        assert np.all(np.diff(self.indptr) >= 0)
        assert len(self.indices) == self.m
        if self.m:
            assert self.indices.min() >= 0 and self.indices.max() < self.n
        if self.weights is not None:
            assert len(self.weights) == self.m

    def reverse(self) -> "Graph":
        """CSC view as a CSR graph over reversed edges (in-edges)."""
        order = np.argsort(self.indices, kind="stable")
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.out_degrees())
        new_indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(new_indptr, self.indices + 1, 1)
        new_indptr = np.cumsum(new_indptr)
        w = self.weights[order] if self.weights is not None else None
        return Graph(new_indptr, src[order], w)


def from_edges(src, dst, n: Optional[int] = None, weights=None,
               dedup: bool = False) -> Graph:
    """Build a CSR graph from an edge list."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if dedup and len(src):
        key = src * n + dst
        _, keep = np.unique(key, return_index=True)
        src, dst = src[keep], dst[keep]
        if weights is not None:
            weights = np.asarray(weights)[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    w = None
    if weights is not None:
        w = np.asarray(weights, dtype=np.float32)[order]
    return Graph(indptr, dst.astype(np.int32), w)


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         weighted: bool = False, dedup: bool = True) -> Graph:
    """RMAT generator (paper §6: default Graph500-style scale-free, deg 16)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        # quadrant choice per Chakrabarti et al. [9]
        go_right = (r >= a) & (r < ab) | (r >= abc)
        go_down = r >= ab
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    # permute vertex ids so degree is not index-correlated (standard practice)
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    w = rng.random(m).astype(np.float32) + 0.01 if weighted else None
    return from_edges(src, dst, n=n, weights=w, dedup=dedup)


def uniform_random(n: int, m: int, seed: int = 0,
                   weighted: bool = False) -> Graph:
    """Erdos-Renyi-ish uniform random directed graph."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32) + 0.01 if weighted else None
    return from_edges(src, dst, n=n, weights=w, dedup=True)


def ring(n: int, weighted: bool = False) -> Graph:
    src = np.arange(n)
    dst = (src + 1) % n
    w = np.ones(n, dtype=np.float32) if weighted else None
    return from_edges(src, dst, n=n, weights=w)


def star(n: int) -> Graph:
    """Vertex 0 points to all others (max skew for bin-size stress tests)."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n)
    return from_edges(src, dst, n=n)


def grid2d(rows: int, cols: int, weighted: bool = False,
           seed: int = 0) -> Graph:
    """4-neighbor grid — large diameter (stresses frontier algorithms)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    src, dst = [], []
    src.append(idx[:, :-1].ravel()); dst.append(idx[:, 1:].ravel())
    src.append(idx[:, 1:].ravel()); dst.append(idx[:, :-1].ravel())
    src.append(idx[:-1, :].ravel()); dst.append(idx[1:, :].ravel())
    src.append(idx[1:, :].ravel()); dst.append(idx[:-1, :].ravel())
    src = np.concatenate(src); dst = np.concatenate(dst)
    w = None
    if weighted:
        w = np.random.default_rng(seed).random(len(src)).astype(np.float32) + 0.01
    return from_edges(src, dst, n=rows * cols, weights=w)


def symmetrize(g: Graph) -> Graph:
    """Undirected view: every edge exists in both directions with ONE
    canonical weight per unordered pair (the minimum of the directed
    weights, when both existed).  The result satisfies
    ``d(u, v) == d(v, u)`` exactly — the precondition for the serving
    tier's landmark seeding (:mod:`repro.serve.cache`) and for weakly-
    connected components.  Parallel edges are deduplicated."""
    src = np.repeat(np.arange(g.n, dtype=np.int64), g.out_degrees())
    dst = g.indices.astype(np.int64)
    u = np.minimum(src, dst)
    v = np.maximum(src, dst)
    key = u * g.n + v
    if g.weights is None:
        uniq = np.unique(key)
        wmin = None
    else:
        order = np.argsort(key, kind="stable")
        key_s, w_s = key[order], g.weights[order]
        uniq, start = np.unique(key_s, return_index=True)
        # one canonical weight per unordered pair: min over both
        # directions (and any parallel duplicates)
        wmin = np.minimum.reduceat(w_s, start)
    u2, v2 = uniq // g.n, uniq % g.n
    loop = u2 == v2                       # self loops emitted once
    src2 = np.concatenate([u2, v2[~loop]])
    dst2 = np.concatenate([v2, u2[~loop]])
    w2 = (None if wmin is None
          else np.concatenate([wmin, wmin[~loop]]).astype(np.float32))
    return from_edges(src2, dst2, n=g.n, weights=w2)


def to_scipy(g: Graph):
    import scipy.sparse as sp
    data = g.weights if g.weights is not None else np.ones(g.m, np.float32)
    return sp.csr_matrix((data, g.indices, g.indptr), shape=(g.n, g.n))

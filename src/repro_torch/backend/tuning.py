"""Tile-geometry autotuner: sweep ``edge_tile`` / ``msg_tile`` (and the fold
knobs ``fold_tile`` / ``fold_q`` where the kernels read them).

Counterpart of :mod:`repro.backend.tuning`, with the same names, record
format and cache.  The paper's §3.1 sizing rule fixes ``q``; what it leaves
open is the streaming granularity of the bins, here the tile geometry of the
layout.  :func:`autotune` builds a layout per candidate, times one call of
each kernel on it (:func:`time_layout`), keeps the fastest by summed time
and caches it on disk (``results/tuning/*.json``, or ``REPRO_TUNING_DIR``).
:func:`repro_torch.graph.build_layout` reads the same cache when its tile
arguments are left unset, so one sweep feeds every later layout of the same
graph family on this host.

Cache entries are keyed by (platform, backend, log2-bucketed graph size,
partition count, weighted) as in the reference.  The port's platform is
``"cuda"`` on a card and ``"cpu"`` otherwise, and its backend ``"cuda"``
(the CUDA kernels) or ``"plain"`` (the plain PyTorch versions, which the
CPU runs), so a port key (``cuda-cuda-n...``, ``cpu-plain-n...``) never
reads a reference entry (``cpu-ref-...``, ``tpu-pallas-native-...``).

On the card only ``edge_tile`` and ``msg_tile`` are swept: the CUDA segment
fold reads neither ``fold_tile`` nor ``fold_q``, and a knob the kernels
ignore must not be swept, or the winner is chosen by timing jitter (the
reference's own rule, ``repro/backend/tuning.py:157-162``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.engine import resolve_device
from ..kernels.ops import (FoldKernel, FusedDCKernel, GatherKernel,
                           ScatterKernel, SpmvKernel)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    edge_tile: int = 256
    msg_tile: int = 128
    fold_tile: int = 256
    fold_q: int = 256         # two-level fold bucket width (over-cap regime)


DEFAULT_GEOMETRY = TileGeometry()

# Candidate sweeps per platform.  The CPU's are the reference's.  On the
# card the destination-major kernels walk one edge tile per warp, so
# edge_tile sets how much of a partition's edge stream one warp reads
# between tile-level skips; msg_tile follows it, and the fold knobs, which
# the CUDA kernels do not read, stay fixed.
CANDIDATES = {
    "cpu": (TileGeometry(64, 32, 64, 64), TileGeometry(128, 64, 128, 128),
            TileGeometry(128, 64, 256, 128),
            TileGeometry(256, 128, 256, 256),
            TileGeometry(256, 128, 512, 256),
            TileGeometry(512, 256, 512, 512)),
    "cuda": tuple(TileGeometry(e, e // 2, 256, 256)
                  for e in (128, 256, 512, 1024)),
}
KERNEL_ROWS = ("gather", "scatter", "spmv", "fold", "fold2", "fused")
#: the reference fold's segment cap, past which its two-level fold runs; the
#: ``fold2`` row times a stream just past it, as the reference's does
FOLD_CAP = 4096

ENV_DIR = "REPRO_TUNING_DIR"
_REPO_ROOT = Path(__file__).resolve().parents[3]


def default_platform() -> str:
    """``"cuda"`` when torch sees a card, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_name(platform: str) -> str:
    """The kernels' versions a platform runs: the CUDA kernels on a card,
    the plain PyTorch versions on the CPU."""
    return "cuda" if platform == "cuda" else "plain"


def candidates(platform: Optional[str] = None) -> tuple[TileGeometry, ...]:
    platform = platform or default_platform()
    return CANDIDATES.get(platform, CANDIDATES["cpu"])


def cache_dir_path(cache_dir=None) -> Path:
    if cache_dir is not None:
        return Path(cache_dir)
    env = os.environ.get(ENV_DIR)
    return Path(env) if env else _REPO_ROOT / "results" / "tuning"


def _cache_key(n: int, m: int, k: int, weighted: bool, platform: str,
               backend: str) -> str:
    # log2 buckets: one sweep covers the whole scale family
    return (f"{platform}-{backend}-n{int(n).bit_length()}"
            f"-m{int(m).bit_length()}-k{k}-{'w' if weighted else 'u'}")


def load_cached(n, m, k, weighted, platform, backend,
                cache_dir=None) -> Optional[TileGeometry]:
    path = cache_dir_path(cache_dir) / (
        _cache_key(n, m, k, weighted, platform, backend) + ".json")
    if not path.exists():
        return None
    try:
        rec = json.loads(path.read_text())
        # an entry missing a knob was swept without it: a miss, so that
        # autotune() sweeps again
        return TileGeometry(int(rec["edge_tile"]), int(rec["msg_tile"]),
                            int(rec["fold_tile"]), int(rec["fold_q"]))
    except (ValueError, KeyError):
        return None


def resolve_geometry(n: int, m: int, k: int, weighted: bool = False,
                     platform: Optional[str] = None, backend=None,
                     cache_dir=None) -> TileGeometry:
    """Tuned geometry if a cached sweep covers this graph family, else the
    static default.  Never runs a sweep itself (layout builds stay cheap)."""
    platform = platform or default_platform()
    bname = backend or backend_name(platform)
    return (load_cached(n, m, k, weighted, platform, bname, cache_dir)
            or DEFAULT_GEOMETRY)


def _timed(fn, reps: int, device: torch.device) -> float:
    """Best wall time of ``reps`` calls after a warm-up call; on a card each
    call is bracketed by ``torch.cuda.synchronize()``."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    best = np.inf
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def time_layout(layout, device, kernels=KERNEL_ROWS, reps: int = 3,
                monoid: str = "add") -> dict:
    """Seconds for one call of each kernel on a built layout, on
    ``device``: the reference's rows on the reference's synthetic inputs
    (NumPy ``default_rng(0)``, f32).  ``gather``, ``scatter`` and ``spmv``
    run the composed path's kernels over every partition; ``fold`` folds the
    layout's edge stream into ``n_pad + 1`` segments, ``fold2`` a sorted
    synthetic stream into just past :data:`FOLD_CAP` segments; ``fused`` is
    the fused DC step over the layout's edges, every source live."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out = {}
    f32 = torch.float32

    def put(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    edge_valid = put(layout.edge_valid.astype(bool))
    if "gather" in kernels:
        gk = GatherKernel(layout, monoid, f32, dev)
        ev = put(rng.integers(0, 64, layout.num_edges).astype(np.float32))
        pa = torch.ones(layout.k, dtype=torch.bool, device=dev)
        out["gather"] = _timed(lambda: gk(ev, edge_valid, pa), reps, dev)
    if "scatter" in kernels:
        sk = ScatterKernel(layout, monoid, f32, dev)
        x = put(rng.integers(0, 64, layout.n_pad).astype(np.float32))
        act = torch.ones(layout.n_pad, dtype=torch.bool, device=dev)
        out["scatter"] = _timed(lambda: sk(x, act), reps, dev)
    if "spmv" in kernels:
        vk = SpmvKernel(layout, dev)
        x = put(rng.integers(0, 64, layout.n_pad).astype(np.float32))
        out["spmv"] = _timed(lambda: vk(x), reps, dev)

    def time_fold(key: str, ns: int, ids):
        fold = FoldKernel(monoid)
        fv = put(rng.integers(0, 64, layout.num_edges).astype(np.float32))
        fids = torch.where(edge_valid, put(ids.astype(np.int32)),
                           ns - 1).to(torch.int32)
        out[key] = _timed(lambda: fold(fv, edge_valid, fids, ns), reps, dev)

    if "fold" in kernels:
        # the layout's gather-order edge stream doubles as a realistic
        # message stream: ids = edge destinations, overflow bin = n_pad
        time_fold("fold", layout.n_pad + 1, layout.edge_dst)
    if "fold2" in kernels:
        ns2 = FOLD_CAP + FOLD_CAP // 2 + 1
        time_fold("fold2", ns2,
                  np.sort(rng.integers(0, ns2 - 1, layout.num_edges)))
    if "fused" in kernels:
        fk = FusedDCKernel(layout, monoid, f32, dev)
        table = put(rng.integers(0, 64, layout.n_pad + 1).astype(np.float32))
        tvalid = torch.ones(layout.n_pad + 1, dtype=torch.bool, device=dev)
        tvalid[-1] = False
        out["fused"] = _timed(lambda: fk(table, tvalid), reps, dev)
    return out


def autotune(g, k: Optional[int] = None, device="cuda", kernels=KERNEL_ROWS,
             reps: int = 3, cache_dir=None, force: bool = False,
             layouts: Optional[dict] = None) -> TileGeometry:
    """Sweep the platform's candidate tile geometries for graph ``g`` on
    ``device``; cache the winner.

    Returns the fastest :class:`TileGeometry` by summed kernel time and
    writes it, with every candidate's times, to ``<cache_dir>/<key>.json``,
    so later ``build_layout(..., edge_tile=None)`` calls on the same graph
    family pick it up.  Unless ``force``, a cached entry is returned without
    timing.  ``layouts`` maps a candidate geometry to a layout of ``g``
    already built with it, which the sweep then uses instead of building
    its own.
    """
    from ..graph.layout import build_layout, resolve_k
    dev = resolve_device(device)
    platform = dev.type
    bname = backend_name(platform)
    kk = resolve_k(g.n, k)
    if not force:
        hit = load_cached(g.n, g.m, kk, g.weighted, platform, bname,
                          cache_dir)
        if hit is not None:
            return hit
    sweeps = []
    for geom in candidates(platform):
        L = (layouts or {}).get(geom)
        if L is None:
            L = build_layout(g, k=k, edge_tile=geom.edge_tile,
                             msg_tile=geom.msg_tile,
                             fold_tile=geom.fold_tile, fold_q=geom.fold_q)
        times = time_layout(L, dev, kernels=kernels, reps=reps)
        sweeps.append({"edge_tile": geom.edge_tile,
                       "msg_tile": geom.msg_tile,
                       "fold_tile": geom.fold_tile,
                       "fold_q": geom.fold_q,
                       "wall_s": sum(times.values()), "kernels": times})
        del L          # one built layout at a time (GBs at RMAT scale 22)
    best = min(sweeps, key=lambda s: s["wall_s"])
    rec = {
        "edge_tile": best["edge_tile"], "msg_tile": best["msg_tile"],
        "fold_tile": best["fold_tile"], "fold_q": best["fold_q"],
        "platform": platform, "backend": bname,
        "graph": {"n": int(g.n), "m": int(g.m), "k": int(kk),
                  "weighted": bool(g.weighted)},
        "sweep": sweeps,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    cdir = cache_dir_path(cache_dir)
    cdir.mkdir(parents=True, exist_ok=True)
    key = _cache_key(g.n, g.m, kk, g.weighted, platform, bname)
    (cdir / f"{key}.json").write_text(json.dumps(rec, indent=2))
    return TileGeometry(best["edge_tile"], best["msg_tile"],
                        best["fold_tile"], best["fold_q"])


def tuned_layout(g, k: Optional[int] = None, device="cuda", cache_dir=None,
                 force: bool = False, **build_kw):
    """Autotune (or read the cached sweep) and build the layout with the
    winning geometry."""
    from ..graph.layout import build_layout
    geom = autotune(g, k=k, device=device, cache_dir=cache_dir, force=force)
    return build_layout(g, k=k, edge_tile=geom.edge_tile,
                        msg_tile=geom.msg_tile, fold_tile=geom.fold_tile,
                        fold_q=geom.fold_q, **build_kw)

"""Serving launcher: slot-based continuous batching.

Counterpart of :mod:`repro.launch.serve`, on one device (``--device``, the
card by default; ``cpu`` for the CPU).  LM serving, random weights from
seed 0 and prompts from ``numpy.random.default_rng(0)``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --requests 8

Graph-analytics serving (--graph; everything routes through
:class:`repro_torch.serve.ServeConfig`):

  PYTHONPATH=src python -m repro_torch.launch.serve --graph --scale 10 \
      --queries 64 --app sssp --cache-dir /tmp/serve-cache

The reference's ``--ckpt`` (its checkpoints come with training) and its
mesh placement of the weights are not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.engine import resolve_device
from ..models import LM
from ..serve import GraphQuery, GraphQueryServer, Request, ServeConfig, Server


def serve_graph(args):
    """Stand up a GraphQueryServer over a symmetrized RMAT graph and
    push Zipf-skewed repeat-source traffic through it."""
    from ..graph import build_layout, rmat, symmetrize

    g = symmetrize(rmat(args.scale, seed=0, weighted=(args.app == "sssp")))
    layout = build_layout(g, k=args.parts)
    cfg = ServeConfig(max_batch=args.max_batch,
                      cache_size=args.cache_size,
                      cache_backend=args.cache_dir,
                      semantic=not args.no_semantic,
                      warm_threshold=args.warm_threshold)
    srv = GraphQueryServer(layout, cfg, device=args.device)
    rng = np.random.default_rng(0)
    # Zipf-skewed sources: repeat traffic exercises the exact-result
    # entries, near-landmark traffic the seeded path
    pool = rng.integers(0, layout.n, 16)
    for i in range(args.queries):
        src = int(pool[min(rng.zipf(1.5) - 1, len(pool) - 1)])
        srv.submit(GraphQuery(qid=i, app=args.app, params={"source": src}))
    t0 = time.time()
    done = srv.run()
    dt = time.time() - t0
    st = srv.cache.stats()
    print(f"[serve-graph] {len(done)} {args.app} queries in {dt:.2f}s "
          f"({len(done) / dt:.1f} q/s) on {srv.device}")
    print(f"[serve-graph] result hits {srv.cache_hits} / misses "
          f"{srv.cache_misses}; semantic hits {srv.semantic_hits} / "
          f"misses {srv.semantic_misses}; backend {st}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", action="store_true",
                    help="serve graph-analytics queries instead of an LM")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; a card must exist) or 'cpu'")
    ap.add_argument("--arch")
    ap.add_argument("--app", default="sssp",
                    choices=["bfs", "sssp", "sssp_parents"])
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--parts", type=int, default=16)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--cache-size", type=int, default=128)
    ap.add_argument("--cache-dir", default=None,
                    help="disk-backed cache directory (default: in-memory)")
    ap.add_argument("--no-semantic", action="store_true")
    ap.add_argument("--warm-threshold", type=int, default=3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    if args.graph:
        return serve_graph(args)
    if not args.arch:
        ap.error("--arch is required unless --graph is given")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.decoder:
        raise SystemExit(f"{args.arch} is encoder-only; no decode serving")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = LM(cfg, device=dev, generator=gen)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    srv = Server(model, n_slots=args.slots, max_len=args.max_len,
                 dtype=dtype)
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        srv.submit(Request(rid=r,
                           prompt=rng.integers(0, cfg.vocab,
                                               rng.integers(4, 16),
                                               dtype=np.int32),
                           max_new=args.max_new))
    t0 = time.time()
    done = srv.run()
    dt = time.time() - t0
    tok = sum(len(d.out) for d in done)
    print(f"[serve] {len(done)} requests, {tok} tokens, {dt:.1f}s "
          f"({tok / dt:.1f} tok/s) on {dev}")


if __name__ == "__main__":
    main()

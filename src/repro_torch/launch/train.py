"""Training launcher.

Counterpart of :mod:`repro.launch.train`, on one device (``--device``, the
card by default; ``cpu`` for the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --steps 100 --global-batch 8 --ckpt /ckpts/qwen2 [--smoke] \
      [--microbatches 4] [--int8-grads] [--data tokens.bin]

Random weights from seed 0, the compute dtype the config's (bf16 with an
f32 master in the optimizer, or f32); batches from
:class:`repro_torch.train.TokenPipeline` (seeded, or a memmap of
``--data``).  Fault tolerance: SIGTERM triggers a checkpoint at the end of
the step in flight, then the exit; restart with the same ``--ckpt`` resumes
from its latest step.  The
reference's ``--multi-pod`` (a production mesh over pods) is not ported:
the port trains on one device.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from ..configs import get_config, get_smoke_config
from ..core.engine import resolve_device
from ..models import LM
from ..train import (DataConfig, OptConfig, TokenPipeline, checkpoint,
                     init_opt_state, make_train_step)


class StepWatchdog:
    """Straggler mitigation at the job level: if a step exceeds
    ``factor`` x the trailing median, log it (on real fleets: report the
    slow host for replacement; deterministic data means any restarted
    worker replays identically)."""

    def __init__(self, factor: float = 3.0, window: int = 20):
        self.times, self.factor, self.window = [], factor, window
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        hist = sorted(self.times[-self.window:])
        med = hist[len(hist) // 2]
        slow = len(self.times) > 5 and dt > self.factor * med
        self.flagged += int(slow)
        return slow


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; a card must exist) or 'cpu'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_train")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--int8-grads", action="store_true")
    ap.add_argument("--data", default=None, help="binary token file")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    seq = args.seq or (64 if args.smoke else 4096)
    gb = args.global_batch or (8 if args.smoke else 256)
    print(f"[train] {cfg.name} seq={seq} gb={gb} device={dev}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = LM(cfg, device=dev, generator=gen)
    ocfg = OptConfig(total_steps=args.steps, int8_compress=args.int8_grads,
                     compute_dtype=cfg.dtype)
    opt = init_opt_state(model, ocfg)
    if ocfg.compute_dtype == "bfloat16":
        model.to_compute(torch.bfloat16)
    step_fn = make_train_step(model, ocfg, microbatches=args.microbatches)
    pipe = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=0,
        path=args.data,
        embed_dim=cfg.d_model if cfg.frontend else None))

    start = checkpoint.latest_step(args.ckpt) or 0
    if start:
        opt, start = checkpoint.restore(args.ckpt, model, opt)
        print(f"[train] resumed at step {start}", flush=True)

    # the step rewrites the weights in place, so a SIGTERM is served at the
    # end of the step in flight, never halfway through an update
    term = []
    signal.signal(signal.SIGTERM, lambda signum, frame: term.append(signum))
    wd = StepWatchdog()
    for i in range(start, args.steps):
        t0 = time.time()
        m = step_fn(opt, pipe.batch_at(i))
        loss = float(m["loss"])            # waits for the step to finish
        dt = time.time() - t0
        if wd.observe(dt):
            print(f"[watchdog] slow step {i}: {dt:.2f}s", flush=True)
        if i % 10 == 0:
            print(f"step {i:6d} loss {loss:.4f} {dt:.2f}s/step", flush=True)
        if term:
            print("[train] SIGTERM: checkpointing before exit", flush=True)
            checkpoint.save(args.ckpt, i + 1, model, opt)
            sys.exit(0)
        if (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt, i + 1, model, opt)
    checkpoint.save(args.ckpt, args.steps, model, opt)
    print(f"[train] done ({wd.flagged} straggler steps flagged)", flush=True)


if __name__ == "__main__":
    main()

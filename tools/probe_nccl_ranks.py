"""Probe whether NCCL runs several ranks on one CUDA device.

    python tools/probe_nccl_ranks.py [--ranks 2] [--device 0]

Starts a process group of world size 1, then one of ``--ranks``, every rank
on the same card (a file store in a temporary directory, a 60 s collective
timeout, a 90 s wall limit a rank), and has each rank run one
``all_to_all_single`` and one ``all_reduce``.  Prints each world size's
outcome (each rank's exit code and the end of its output) and exits 0 when
every world size ran, 1 when one failed.  The distributed engine's runs on a
machine with one card are at world size 1 unless this passes for 2.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile


def rank_main(rank: int, world: int, store: str, device: int) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        x = torch.full((world, 8), rank, dtype=torch.int32, device="cuda")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        total = torch.full((3,), float(rank + 1), device="cuda")
        dist.all_reduce(total)
        torch.cuda.synchronize()
        print(f"rank {rank}: all_to_all {out[:, 0].tolist()}, "
              f"all_reduce {total.tolist()}", flush=True)
    finally:
        dist.destroy_process_group()


def world_runs(world: int, device: int) -> bool:
    store = os.path.join(tempfile.mkdtemp(prefix="probe_nccl_"), "store")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world),
         "--store", store, "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    ok = True
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n(killed at the 90 s wall limit)"
        ok &= p.returncode == 0
        tail = "\n    ".join(out.strip().splitlines()[-6:])
        print(f"world {world} rank {r}: exit {p.returncode}\n    {tail}",
              flush=True)
    print(f"world {world}: {'ran' if ok else 'FAILED'}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", type=int, default=0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is not None:
        rank_main(a.rank, a.world, a.store, a.device)
        return 0
    ok = [world_runs(w, a.device) for w in sorted({1, a.ranks})]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())

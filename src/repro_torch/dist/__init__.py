"""Multi-device machinery of the port: the rank group that the distributed
PPM engine (:mod:`repro_torch.dist.engine`) exchanges its bins over.

GPOP executes graph algorithms as partition-parallel BSP supersteps (paper
§3), and each superstep maps onto the ranks like so:

  Scatter   every partition streams its active vertices' messages into
            per-destination-partition bins: local writes on whichever rank
            owns the partition;
  Sync      the bin exchange, the superstep's only communication: one
            all-to-all over every rank of the group;
  Gather    every partition folds the bins it owns with the app monoid,
            again local to the owning rank.

The reference runs one controller over a JAX device mesh (``shard_map``).
Here one process runs each rank (SPMD) over ``torch.distributed``: NCCL
between CUDA devices, gloo between CPU ranks.  The caller initialises the
process group, as ``torchrun`` does, or with ``init_process_group(backend,
init_method=..., world_size=..., rank=...)``; :func:`make_mesh` then names
the rank's device.  The reference's JAX version shims (``compat``) have no
counterpart; the LM stack's sharding rules are :mod:`.sharding`, over the
named meshes of :mod:`repro_torch.launch.mesh`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from ..core.engine import resolve_device

#: the process-group backend each device type exchanges through
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of its process group: the flat device axis the PPM
    bin exchange runs over (the reference's mesh flattened to one group)."""
    group: Any                  # the process group (None: the default one)
    rank: int
    size: int
    device: torch.device        # this rank's device
    axis_names: tuple = ("dev",)


def make_mesh(device="cuda") -> Mesh:
    """This rank's :class:`Mesh` over the default process group, which
    must be initialised.

    ``device="cuda"`` takes ``cuda:<LOCAL_RANK>`` (``cuda:0`` when
    ``LOCAL_RANK`` is unset) and makes it the current CUDA device, as NCCL
    needs; ``"cpu"`` runs the ranks on the CPU.  A CUDA device needs the
    group's backend to be NCCL and the CPU needs gloo: any other pairing
    raises, as does a missing card."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "repro_torch.dist needs an initialised process group: call "
            "torch.distributed.init_process_group (or run under torchrun) "
            "before make_mesh")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    want = BACKENDS.get(dev.type)
    backend = str(dist.get_backend())
    if want is None or backend != want:
        raise ValueError(f"a {dev.type} mesh exchanges through "
                         f"{want or 'no backend'}, and the process group's "
                         f"backend is {backend!r}")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=None, rank=dist.get_rank(),
                size=dist.get_world_size(), device=dev)


__all__ = ["BACKENDS", "Mesh", "make_mesh"]

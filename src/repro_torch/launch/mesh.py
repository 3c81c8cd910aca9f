"""The LM stack's device meshes.

Counterpart of :mod:`repro.launch.mesh`: named ``torch.distributed``
``DeviceMesh`` es (``init_device_mesh``) over the initialised process
group, one rank a device, with the reference's axis names: ``("data",
"model")``, and ``"pod"`` in front across pods.  The graph engine's flat
rank axis is another mesh (:class:`repro_torch.dist.Mesh`).

A CUDA mesh needs the group's backend to be NCCL and a CPU one gloo
(:data:`repro_torch.dist.BACKENDS`); any other pairing raises, as does a
missing card.  Building a mesh needs the group; importing this module
touches nothing.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.engine import resolve_device
from ..dist import BACKENDS


def make_lm_mesh(shape, axis_names, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over every rank of the initialised
    process group, its axes named ``axis_names``, ranks laid out in row
    order (rank ``r`` at the mesh coordinates of ``r``).  ``device``
    ``"cuda"`` makes ``cuda:<LOCAL_RANK>`` the current device (``cuda:0``
    when ``LOCAL_RANK`` is unset); ``"cpu"`` puts the ranks on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "an LM mesh needs an initialised process group: call "
            "torch.distributed.init_process_group (or run under torchrun) "
            "first")
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         "in length")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} ranks; "
                         f"the process group has {world}")
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
    return init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)


def make_local_mesh(device="cuda"):
    """Every rank on the data axis: ``(world, 1)`` over ``("data",
    "model")`` (tests, examples, the serve launcher)."""
    return make_lm_mesh((dist.get_world_size() if dist.is_initialized()
                         else 0, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks);
    any other world size raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_lm_mesh(shape, axes, device)

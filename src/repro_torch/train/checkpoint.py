"""Checkpointing with atomic commit, restore onto any device, and an async
mode.

Counterpart of :mod:`repro.train.checkpoint`, in its on-disk format: one
``ckpt_XXXXXXXX.npz`` of leaves ``p_0 ...`` (the params) and ``o_0 ...``
(the optimizer state), a ``ckpt_XXXXXXXX.json`` manifest (``step``,
``n_params``, ``n_opt``, ``extra``) and a ``LATEST`` file naming the newest
step.  Every file is written to a temporary name and moved into place with
``os.replace``, the npz first and ``LATEST`` last, so a preemption mid-save
never corrupts the latest checkpoint.

Leaf order: the params in the model's ``state_dict()`` order; then the
optimizer state's keys sorted (as ``jax.tree_util`` flattens a dict:
``ef``, ``m``, ``master``, ``step``, ``v``), a tensor as one leaf and a
tree of params as its leaves in the params' order.  NumPy has no bfloat16,
so a bf16 leaf is stored as its uint16 bits; the manifest's ``dtypes``
(one torch dtype name a leaf, params first) says how to read each back.
The reference re-shards a restored checkpoint onto the current mesh; here
:func:`restore` copies it onto whatever device the model lives on.

``AsyncCheckpointer`` overlaps the npz write with training: the tensors are
copied to the host synchronously, the write happens on a worker thread,
and ``wait()`` joins it at the next save or at exit.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn


def _opt_leaves(opt_state: dict, names) -> list:
    leaves = []
    for key in sorted(opt_state):
        tree = opt_state[key]
        if isinstance(tree, dict):
            leaves += [tree[n] for n in names]
        else:
            leaves.append(tree)
    return leaves


def _to_host(x):
    """(a NumPy copy, the torch dtype name) of a tensor."""
    x = x.detach().to("cpu", copy=True)
    name = str(x.dtype).removeprefix("torch.")
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), name
    return x.numpy(), name


def _host_leaves(model: nn.Module, opt_state: dict):
    ps = model.state_dict()
    return ([_to_host(x) for x in ps.values()],
            [_to_host(x) for x in _opt_leaves(opt_state, list(ps))])


def _write(path: str, step: int, leaves_p, leaves_o, extra):
    os.makedirs(path, exist_ok=True)
    arrays = {f"p_{i}": a for i, (a, _) in enumerate(leaves_p)}
    arrays.update({f"o_{i}": a for i, (a, _) in enumerate(leaves_o)})
    manifest = {"step": int(step), "n_params": len(leaves_p),
                "n_opt": len(leaves_o), "extra": extra or {},
                "dtypes": [d for _, d in leaves_p + leaves_o]}
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    final = os.path.join(path, f"ckpt_{step:08d}.npz")
    os.replace(tmp, final)
    mtmp = tmp + ".json"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(path, f"ckpt_{step:08d}.json"))
    _update_latest(path, step)
    return final


def save(path: str, step: int, model: nn.Module, opt_state: dict,
         extra: Optional[dict] = None) -> str:
    """Write ``model``'s weights and ``opt_state`` as checkpoint ``step`` of
    ``path``; the npz's path."""
    leaves_p, leaves_o = _host_leaves(model, opt_state)
    return _write(path, step, leaves_p, leaves_o, extra)


def _update_latest(path: str, step: int):
    tmp = os.path.join(path, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(path, "LATEST"))


def latest_step(path: str) -> Optional[int]:
    f = os.path.join(path, "LATEST")
    if not os.path.exists(f):
        return None
    with open(f) as fh:
        return int(fh.read().strip())


@torch.no_grad()
def restore(path: str, model: nn.Module, opt_state: Optional[dict] = None,
            step: Optional[int] = None):
    """Copy checkpoint ``step`` (the latest by default) of ``path`` into
    ``model``'s weights and, when given, into ``opt_state`` (a tree of the same structure, as
    :func:`repro_torch.train.init_opt_state` makes it), in place, each leaf
    onto its tensor's device and into its dtype.  Returns ``(opt_state,
    step)``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
    with open(os.path.join(path, f"ckpt_{step:08d}.json")) as f:
        manifest = json.load(f)
    dtypes = manifest["dtypes"]
    ps = model.state_dict()
    if manifest["n_params"] != len(ps):
        raise ValueError(f"checkpoint {step} of {path} holds "
                         f"{manifest['n_params']} params, the model "
                         f"{len(ps)}")
    data = np.load(os.path.join(path, f"ckpt_{step:08d}.npz"))

    def load(dst, key, dtype):
        src = torch.from_numpy(np.require(data[key],
                                          requirements=["C", "W"]))
        if dtype == "bfloat16":
            src = src.view(torch.bfloat16)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint leaf {key} has shape "
                             f"{tuple(src.shape)}, not {tuple(dst.shape)}")
        dst.copy_(src)

    for i, dst in enumerate(ps.values()):
        load(dst, f"p_{i}", dtypes[i])
    if opt_state is not None and opt_state:
        leaves = _opt_leaves(opt_state, list(ps))
        if manifest["n_opt"] != len(leaves):
            raise ValueError(f"checkpoint {step} of {path} holds "
                             f"{manifest['n_opt']} optimizer leaves, the "
                             f"state {len(leaves)}")
        for i, dst in enumerate(leaves):
            load(dst, f"o_{i}", dtypes[len(ps) + i])
    return opt_state, step


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training."""

    def __init__(self, path: str):
        self.path = path
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, model: nn.Module, opt_state: dict,
             extra=None):
        self.wait()                           # one in-flight save at a time
        # copy to the host NOW, so training may overwrite the tensors
        leaves_p, leaves_o = _host_leaves(model, opt_state)

        def work():
            try:
                _write(self.path, step, leaves_p, leaves_o, extra)
            except BaseException as e:        # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

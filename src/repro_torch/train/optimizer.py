"""AdamW from scratch (+ LR schedule, grad clip, int8 error-feedback
compression, low-precision compute params with an f32 master).

Counterpart of :mod:`repro.train.optimizer`, written as the reference
writes it (not ``torch.optim.AdamW``), in place.  A parameter tree is a
mapping of names to tensors (an ``nn.Module`` stands for its
``named_parameters()``); the optimizer state holds one tree of the same
names for each of ``m``, ``v`` (and ``master``, ``ef``), and ``step``.

Mixed precision contract: the *compute* params handed to the forward pass
may be bf16; the optimizer keeps an f32 master copy (only then) plus f32
``m`` and ``v``, and rewrites the compute params from the master after each
update, each cast to its own dtype (the SSM's f32 parameters stay f32, see
:meth:`repro_torch.models.LM.to_compute`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Union

import numpy as np
import torch
from torch import nn

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    int8_compress: bool = False          # int8 grads + error feedback
    master_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named(params: Params) -> dict:
    """The parameter tree: ``{name: tensor}`` in the module's order."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_at(cfg: OptConfig, step):
    """Linear warmup to ``cfg.lr``, then cosine decay to 0 at
    ``total_steps``; f32, as the reference computes it."""
    step = torch.as_tensor(step).to(F32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup, 1)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1 + torch.cos(np.pi * prog))
    return torch.where(step < cfg.warmup, warm, cos)


def init_opt_state(params: Params, cfg: OptConfig) -> dict:
    """f32 zeros for ``m`` and ``v`` (and ``ef`` with ``int8_compress``),
    an int32 ``step``, and an f32 ``master`` copy of ``params`` when the
    compute dtype is not f32: call it before casting the model to its
    compute dtype, so the master holds the f32 weights."""
    ps = named(params)
    dev = next(iter(ps.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                for n, p in ps.items()}

    st = {"m": zeros(), "v": zeros(),
          "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.compute_dtype != "float32":
        st["master"] = {n: p.detach().to(F32, copy=True)
                        for n, p in ps.items()}
    if cfg.int8_compress:
        st["ef"] = zeros()
    return st


def _compress_int8(gs: dict, ef: dict, group):
    """The reference's int8 round trip with error feedback over one leaf:
    ``group``'s ``(name, rows)`` parts of the grads ``gs``, quantized with
    one scale (their largest magnitude / 127); ``ef`` keeps what the
    rounding lost."""
    parts = [(gs[n][rows] + ef[n][rows], n, rows) for n, rows in group]
    scale = torch.clamp(torch.stack([s.abs().max() for s, _, _ in parts])
                        .max(), min=1e-12) / 127.0
    for s, n, rows in parts:
        q = torch.clamp(torch.round(s / scale), -127, 127).to(torch.int8)
        deq = q.to(F32) * scale
        ef[n][rows] = s - deq
        gs[n][rows] = deq


@torch.no_grad()
def adamw_update(params: Params, grads: Mapping[str, torch.Tensor],
                 state: dict, cfg: OptConfig, *, leaves=None) -> dict:
    """One AdamW step, in place: ``state`` (``m``, ``v``, ``step``,
    ``master``, ``ef``) and the compute ``params`` are rewritten.  The
    global gradient norm (sum of squares in f32) clips the grads, widened to
    f32; with ``int8_compress`` each leaf is quantized to int8 with error
    feedback, a leaf being a group of ``leaves`` (``[(name, rows), ...]``,
    as :func:`repro_torch.models.transformer.reference_leaves` gives the
    reference's) or, by default, one parameter; the bias corrections ``1 -
    b**step`` are f32; weight decay applies to every parameter.  Returns
    ``{"lr", "grad_norm"}`` (0-d tensors)."""
    ps = named(params)
    names = list(ps)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gs = [grads[n] for n in names]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in gs))
    one = torch.ones((), dtype=F32, device=gnorm.device)
    scale = torch.minimum(one, cfg.clip_norm * one
                          / torch.clamp(gnorm, min=1e-12))
    gs = list(torch._foreach_mul([g.to(F32) for g in gs], scale))

    if cfg.int8_compress:
        by_name = dict(zip(names, gs))
        for group in leaves or [[(n, slice(None))] for n in names]:
            _compress_int8(by_name, state["ef"], group)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(F32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    ms = [state["m"][n] for n in names]
    vs = [state["v"][n] for n in names]
    master = state.get("master")
    ws = ([master[n] for n in names] if master is not None
          else [ps[n] for n in names])
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                               1 - b2))
    del gs
    upd = torch._foreach_div(ms, bc1)                      # m hat
    den = torch._foreach_div(vs, bc2)                      # v hat
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(upd, den)
    del den
    torch._foreach_add_(upd, torch._foreach_mul(ws, cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(ws, upd)
    del upd
    if master is not None:
        for n, w in zip(names, ws):
            ps[n].copy_(w)
    state["step"] = step
    return {"lr": lr, "grad_norm": gnorm}

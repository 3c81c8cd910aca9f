"""Mixture-of-Experts with PPM-style capacity dispatch.

Counterpart of the ``dense_dp`` half of :mod:`repro.models.moe`: token ->
expert routing as partition-centric message passing (tokens are source
vertices, experts partitions, the router's choice the frontier), with
per-batch-row capacity bins filled by a scatter and read back by a gather.
The reference's ``ppm_ep`` (expert parallelism through one ``all_to_all``
each way) needs a device mesh and is not ported; the port runs ``dense_dp``
whatever ``cfg.moe_impl`` says.

The order of bin insertion is the reference's: bin positions are taken one
top-k slot after another, so every token's first choice is placed before
any token's second choice, and the capacity drops fall on the same
(token, choice) pairs.  Dropped pairs go to the overflow row ``E * cap``.
Top-k ties break toward the lower expert id, as ``jax.lax.top_k`` breaks
them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, init_linear, linear


class MoE(nn.Module):
    """Router (``nn.Linear(d, E)``) and stacked expert weights ``w1``,
    ``w3`` [E, d, ff] and ``w2`` [E, ff, d] (the reference's layout), plus
    llama4's shared expert (an :class:`MLP`) when ``cfg.moe_shared_expert``.
    """

    def __init__(self, cfg, device=None):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
        self.cfg = cfg
        self.router = nn.Linear(d, E, bias=False, device=device)
        self.w1 = nn.Parameter(torch.empty(E, d, ff, device=device))
        self.w3 = nn.Parameter(torch.empty(E, d, ff, device=device))
        self.w2 = nn.Parameter(torch.empty(E, ff, d, device=device))
        self.shared = MLP(d, ff, device) if cfg.moe_shared_expert else None

    def reset_parameters(self, generator):
        d, ff = self.cfg.d_model, self.cfg.moe_d_ff
        init_linear(self.router, generator)
        with torch.no_grad():
            for w, scale in ((self.w1, d), (self.w3, d), (self.w2, ff)):
                w.normal_(0.0, 1.0, generator=generator)
                w.mul_(1.0 / np.sqrt(scale))
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def forward(self, x):
        return moe_fwd_dense(self, x)


def _route(moe: MoE, x):
    """Top-k routing in f32 logits.  Returns (idx [B,S,k], weights [B,S,k]).
    A stable descending sort keeps the lower expert id first among equal
    logits."""
    logits = linear(moe.router, x).to(torch.float32)
    w, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = moe.cfg.moe_top_k
    return idx[..., :k], torch.softmax(w[..., :k], dim=-1)


def _dispatch_positions(idx, E: int, capacity: int):
    """Per-batch-row bin positions (the PPM bin-insertion walk).

    idx: [B, S, k] expert ids.  Returns pos [B, S, k], the position within
    the (row, expert) bin, and keep [B, S, k] (the capacity drop mask).
    Slot j's positions follow every earlier slot's in the same bin.
    """
    B, S, k = idx.shape
    counts = torch.zeros(B, E, dtype=torch.int64, device=idx.device)
    poss = []
    for j in range(k):
        oh = F.one_hot(idx[:, :, j], E)                         # [B,S,E]
        ranks = torch.cumsum(oh, dim=1) - 1
        pos_j = ranks.gather(2, idx[:, :, j:j + 1])[..., 0] \
            + counts.gather(1, idx[:, :, j])
        counts = counts + oh.sum(dim=1)
        poss.append(pos_j)
    pos = torch.stack(poss, dim=2)
    return pos, pos < capacity


def moe_fwd_dense(moe: MoE, x):
    """DC-like dense capacity dispatch (the reference's ``moe_fwd_dense``),
    in x's dtype.  ``cap = ceil(S * k / E * capacity)``: 1 at decode."""
    cfg = moe.cfg
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    dtype = x.dtype
    cap = int(math.ceil(S * k / E * cfg.moe_capacity))
    idx, wts = _route(moe, x)
    pos, keep = _dispatch_positions(idx, E, cap)

    # scatter tokens into bins [B, E*cap (+ the overflow row), d]; kept
    # slots are distinct, dropped ones all land on the overflow row
    flat_slot = torch.where(keep, idx * cap + pos, E * cap)     # [B,S,k]
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
    xe = torch.zeros(B, E * cap + 1, d, dtype=dtype, device=x.device)
    for j in range(k):
        xe.index_put_((rows, flat_slot[:, :, j]), x, accumulate=True)
    xe = xe[:, :-1].reshape(B, E, cap, d)

    h = F.silu(torch.einsum("becd,edf->becf", xe, moe.w1)) \
        * torch.einsum("becd,edf->becf", xe, moe.w3)
    ye = torch.einsum("becf,efd->becd", h, moe.w2)
    ye = torch.cat([ye.reshape(B, E * cap, d),
                    torch.zeros(B, 1, d, dtype=dtype, device=x.device)], 1)

    # combine (gather back with router weights)
    out = torch.zeros(B, S, d, dtype=dtype, device=x.device)
    for j in range(k):
        yj = ye.gather(1, flat_slot[:, :, j:j + 1].expand(B, S, d))
        out = out + yj * (wts[:, :, j] * keep[:, :, j])[..., None].to(dtype)
    if moe.shared is not None:
        out = out + moe.shared(x)
    return out


def moe_ref(moe: MoE, x):
    """Oracle: every token through its top-k experts in f32, no capacity
    drops (the reference's token loop, one expert at a time)."""
    cfg = moe.cfg
    f32 = torch.float32
    xf = x.to(f32)
    idx, wts = _route(moe, xf)
    out = torch.zeros_like(xf)
    w1, w3, w2 = moe.w1.to(f32), moe.w3.to(f32), moe.w2.to(f32)
    for e in range(cfg.moe_experts):
        y = (F.silu(xf @ w1[e]) * (xf @ w3[e])) @ w2[e]
        for j in range(cfg.moe_top_k):
            out = out + torch.where(idx[..., j:j + 1] == e,
                                    wts[..., j:j + 1] * y, 0.0)
    if moe.shared is not None:
        sh = moe.shared
        out = out + (F.silu(xf @ sh.w1.weight.to(f32).T)
                     * (xf @ sh.w3.weight.to(f32).T)) @ sh.w2.weight.to(f32).T
    return out

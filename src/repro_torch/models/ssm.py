"""Mamba2 / SSD (state-space duality) blocks, chunked.

Counterpart of :mod:`repro.models.ssm`.  The SSD algorithm (Dao & Gu, 2024)
splits the selective-state recurrence into intra-chunk attention-like
products and an inter-chunk state recurrence over L/Q chunks (a Python loop
here, a ``lax.scan`` in the reference).  Single-group (G=1) B/C as in
mamba2 defaults.  :func:`ssd_sequential_ref` is the step-by-step oracle.

:class:`Mamba2` holds one block's weights: its ``forward`` is the
reference's ``ssm_block_fwd`` and its ``decode`` its ``ssm_block_decode``.
``dt_bias``, ``A_log``, ``D`` and the depthwise conv's weights are read in
f32 at every use, as the reference reads them, and stay f32 when the model
is cast to a compute dtype (:attr:`Mamba2.F32_PARAMS`).

The reference's bf16 prefill cannot run: its ``causal_conv`` hands
``lax.conv_general_dilated`` f32 activations and bf16 weights, which it
refuses.  The port convolves in f32 with the f32 weights, as the
reference's decode does, and rounds to the activation dtype; in f32 the two
agree.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import init_linear, linear, rms_norm


# ----------------------------------------------------------------------
# causal depthwise conv
# ----------------------------------------------------------------------

def causal_conv(x, w):
    """x: [B, L, C]; w: [C, 1, K] depthwise causal convolution: a
    cross-correlation with K - 1 zeros on the left (no flip), in f32,
    rounded to x's dtype."""
    K = w.shape[-1]
    xt = F.pad(x.to(torch.float32).transpose(1, 2), (K - 1, 0))
    out = F.conv1d(xt, w.to(torch.float32), groups=w.shape[0])
    return out.transpose(1, 2).to(x.dtype)


# ----------------------------------------------------------------------
# chunked SSD
# ----------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, D, chunk: int, h0=None,
                intra_bf16: bool = False):
    """Chunked selective-state-space computation.

    x: [B, L, H, P]; dt: [B, L, H] (already softplus'd); A: [H] (negative);
    B, C: [B, L, N] (single group); D: [H].
    Returns (y [B, L, H, P], final_state [B, H, N, P] f32).
    """
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    f32 = torch.float32
    adt = torch.bfloat16 if intra_bf16 else f32     # bulk-activation dtype
    dev = x.device
    mask = (torch.arange(Q, device=dev)[:, None]
            >= torch.arange(Q, device=dev)[None, :])
    Af = A.to(f32)
    Df = D.to(f32)
    h = (torch.zeros(Bz, H, N, P, dtype=f32, device=dev) if h0 is None
         else h0.to(f32))
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        x_c = x[:, sl].to(adt)                     # [B,Q,H,P]
        dt_c = dt[:, sl].to(f32)                   # [B,Q,H]
        B_c = B[:, sl].to(adt)                     # [B,Q,N]
        C_c = C[:, sl].to(adt)
        a = dt_c * Af                              # log decay
        cum = torch.cumsum(a, dim=1)
        xdt = x_c * dt_c[..., None].to(x_c.dtype)
        # intra-chunk (masked attention-like product); the exponentials
        # stay f32; above the diagonal exp(cum_i - cum_j) overflows and is
        # cut with where (a multiply by the mask would give inf * 0 = NaN)
        scores = torch.einsum("bin,bjn->bij", C_c.to(f32), B_c.to(f32))
        Lmat = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        Lmat = torch.where(mask[None, :, :, None], Lmat, 0.0)  # [B,i,j,H]
        sl_ = scores.to(adt).to(f32)[..., None] * Lmat.to(adt).to(f32)
        y = torch.einsum("bijh,bjhp->bihp", sl_, xdt.to(adt).to(f32))
        # contribution of the incoming state
        y = y + torch.einsum("bin,bhnp->bihp", C_c.to(f32), h) \
            * torch.exp(cum)[..., None]
        y = y + Df[None, None, :, None] * x_c.to(f32)
        # state update
        last = cum[:, -1:, :]                      # [B,1,H]
        S_c = torch.einsum("bjn,bjhp->bhnp", B_c.to(f32),
                           torch.exp(last - cum)[..., None] * xdt.to(f32))
        h = h * torch.exp(last[:, 0, :])[..., None, None] + S_c
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    return y.to(x.dtype), h


def ssd_sequential_ref(x, dt, A, B, C, D, h0=None):
    """Step-by-step oracle: h_t = e^{dt_t A} h_{t-1} + dt_t B_t x_t."""
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    h = (torch.zeros(Bz, H, N, P, dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    ys = []
    for t in range(L):
        dec = torch.exp(dt[:, t] * A)                          # [B,H]
        h = h * dec[..., None, None] + torch.einsum(
            "bn,bhp,bh->bhnp", B[:, t], x[:, t].to(f32), dt[:, t])
        y = torch.einsum("bn,bhnp->bhp", C[:, t], h) \
            + D[None, :, None] * x[:, t].to(f32)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), h


# ----------------------------------------------------------------------
# full Mamba2 block
# ----------------------------------------------------------------------

class Mamba2(nn.Module):
    """One Mamba2 block's weights: the input projections ``wz``, ``wx``,
    ``wB``, ``wC``, ``wdt``; ``dt_bias``, ``A_log``, ``D`` ([H]); the
    depthwise conv over concat(x, B, C) (``conv_weight`` [di + 2N, 1, K],
    ``F.conv1d``'s layout: the reference's ``conv_x``, ``conv_B``,
    ``conv_C`` concatenated and transposed); the gated norm and ``out``."""

    #: read in f32 at every use; kept f32 by ``LM.to_compute``
    F32_PARAMS = ("dt_bias", "A_log", "D", "conv_weight")

    def __init__(self, cfg, device=None):
        super().__init__()
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        H, K = cfg.ssm_heads, cfg.ssm_conv
        self.cfg = cfg
        self.wz = nn.Linear(d, di, bias=False, device=device)
        self.wx = nn.Linear(d, di, bias=False, device=device)
        self.wB = nn.Linear(d, N, bias=False, device=device)
        self.wC = nn.Linear(d, N, bias=False, device=device)
        self.wdt = nn.Linear(d, H, bias=False, device=device)
        self.dt_bias = nn.Parameter(torch.empty(H, device=device))
        self.A_log = nn.Parameter(torch.empty(H, device=device))
        self.D = nn.Parameter(torch.empty(H, device=device))
        self.conv_weight = nn.Parameter(
            torch.empty(di + 2 * N, 1, K, device=device))
        self.norm = nn.Parameter(torch.empty(di, device=device))
        self.out = nn.Linear(di, d, bias=False, device=device)

    def reset_parameters(self, generator):
        for mod in (self.wz, self.wx, self.wB, self.wC, self.wdt, self.out):
            init_linear(mod, generator)
        with torch.no_grad():
            self.dt_bias.zero_()
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.norm.fill_(1.0)
            self.conv_weight.normal_(0.0, 1.0, generator=generator)
            self.conv_weight.mul_(1.0 / np.sqrt(self.cfg.ssm_conv))

    def _proj(self, x):
        """z, xBC (pre-activation, x's dtype) and dt (f32, softplus'd)."""
        z = linear(self.wz, x)
        xBC = torch.cat([linear(self.wx, x), linear(self.wB, x),
                         linear(self.wC, x)], dim=-1)
        dt = F.softplus(linear(self.wdt, x).to(torch.float32)
                        + self.dt_bias.to(torch.float32))
        return z, xBC, dt

    def forward(self, x, *, h0=None, conv0=None, return_state: bool = False):
        """x: [B, L, d_model] -> [B, L, d_model]; with ``return_state`` also
        the final SSM state [B, H, N, P] (f32) and the conv state, the last
        K - 1 rows of the pre-activation xBC [B, K - 1, di + 2N]."""
        cfg = self.cfg
        Bz, L, _ = x.shape
        di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        K = cfg.ssm_conv
        z, xBC, dt = self._proj(x)
        if conv0 is not None:
            xBC_pre = torch.cat([conv0.to(x.dtype), xBC], dim=1)
            xBC = causal_conv(xBC_pre, self.conv_weight)[:, conv0.shape[1]:]
        else:
            if return_state and L < K - 1:
                raise ValueError(
                    f"a prompt of {L} tokens is shorter than the conv "
                    f"state's {K - 1} rows; prefill needs at least {K - 1}")
            xBC_pre = xBC
            xBC = causal_conv(xBC, self.conv_weight)
        xBC = F.silu(xBC)
        xin, Bv, Cv = torch.split(xBC, [di, N, N], dim=-1)
        A = -torch.exp(self.A_log.to(torch.float32))
        y, hT = ssd_chunked(xin.reshape(Bz, L, H, P), dt, A,
                            Bv.to(torch.float32), Cv.to(torch.float32),
                            self.D.to(torch.float32), cfg.ssm_chunk, h0=h0,
                            intra_bf16=cfg.ssm_intra_bf16)
        y = rms_norm(y.reshape(Bz, L, di) * F.silu(z), self.norm,
                     cfg.norm_eps)
        out = linear(self.out, y)
        if return_state:
            return out, hT, xBC_pre[:, -(K - 1):]
        return out

    def decode(self, x, h, conv_state):
        """One token.  x: [B, 1, d]; h: [B, H, N, P] (f32); conv_state:
        [B, K - 1, di + 2N] (pre-activation xBC history).  Returns (out, h,
        conv_state), all new tensors."""
        cfg = self.cfg
        Bz = x.shape[0]
        di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        f32 = torch.float32
        z, xBC, dt = self._proj(x)
        dt = dt[:, 0]                                          # [B,H]
        hist = torch.cat([conv_state.to(x.dtype), xBC], dim=1)  # [B,K,ch]
        conv_out = torch.einsum("bkc,ck->bc", hist.to(f32),
                                self.conv_weight[:, 0].to(f32))
        conv_out = F.silu(conv_out)
        xin1, Bv1, Cv1 = torch.split(conv_out, [di, N, N], dim=-1)
        A = -torch.exp(self.A_log.to(f32))
        dec = torch.exp(dt * A)
        xh = xin1.reshape(Bz, H, P)
        h = h * dec[..., None, None] + torch.einsum(
            "bn,bhp,bh->bhnp", Bv1, xh, dt)
        y = torch.einsum("bn,bhnp->bhp", Cv1, h) \
            + self.D.to(f32)[None, :, None] * xh
        y = rms_norm(y.reshape(Bz, 1, di).to(x.dtype) * F.silu(z), self.norm,
                     cfg.norm_eps)
        return linear(self.out, y), h, hist[:, 1:]

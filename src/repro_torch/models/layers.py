"""Transformer building blocks: RMSNorm, RoPE, chunked GQA attention, SwiGLU.

Counterpart of :mod:`repro.models.layers`.  The functions (``rms_norm``,
``rope``, ``chunked_attention``, ``decode_attention``) compute what the
reference's do and cast in the same places, so bf16 rounds alike; the
attention and MLP layers are ``nn.Module`` s whose ``nn.Linear`` weights
are the transposes of the reference's ``[d_in, d_out]`` matrices.

Every layer computes in its weights' dtype (the compute dtype): the
reference casts its f32 master weights at every use, the port casts them
once (:meth:`repro_torch.models.transformer.LM.to_compute`), which gives
the same numbers; an input of another dtype is refused by the products.  What
every layer of a forward shares (the rotary tables; in a decode step the
ring slots and the cache mask, :class:`DecodeStep`) is made once a
forward.  Attention is chunked with an online softmax (the reference's
flash structure) so that a long prefill never holds more than one
``[B, H, q_chunk, kv_chunk]`` block of scores.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` (the reference's ``x @ w.astype(dtype)``), without the
    module call's hooks."""
    return F.linear(x, mod.weight)


def init_linear(mod: nn.Linear, generator, scale=None):
    """The reference's ``dense_param`` init: N(0, 1) / sqrt(d_in)."""
    d_in = mod.weight.shape[1]
    with torch.no_grad():
        mod.weight.normal_(0.0, 1.0, generator=generator)
        mod.weight.mul_(1.0 / np.sqrt(d_in) if scale is None else scale)


# ----------------------------------------------------------------------
# norms / rotary
# ----------------------------------------------------------------------

def rms_norm(x, w, eps=1e-5):
    """The variance in f32; the scale and the weight cast to x's dtype before
    each multiply, as the reference rounds."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w.to(x.dtype)


def rope_tables(positions, dh: int, theta, device):
    """(cos, sin) of the rotary angles, f32, [..., S, 1, dh / 2] for
    positions [..., S]: ``theta ** (arange / half)`` in f32, as the
    reference computes it.  A forward makes them once for all its layers."""
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=device) / half))
    angles = positions[..., :, None].to(torch.float32) * freqs
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def apply_rope(x, cos, sin):
    """Half-split rotation of x [..., S, H, dh] by :func:`rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta=10_000.0):
    """Rotary embedding, half-split (not interleaved).  x: [..., S, H, dh];
    positions: [..., S].  Angles in f32."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta,
                                      x.device))


# ----------------------------------------------------------------------
# chunked attention (online softmax)
# ----------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """GQA attention with flash-style chunking (contiguous positions).

    q: [B, Sq, H, dh]; k, v: [B, Skv, KV, dh]; H % KV == 0.  Scores in f32,
    masked to -1e30 (causal and window alike), ``l`` clamped at 1e-30, as in
    the reference.  A key chunk that the mask hides whole from a query chunk
    is skipped: in the reference its scores are all -1e30 and its weights
    come out exactly 0 (or are wiped by the first visible chunk's
    correction, exp(-1e30 - m) = 0), so the result is the same.
    """
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    scale = 1.0 / np.sqrt(dh)
    f32 = torch.float32
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, dh).permute(0, 2, 3, 1, 4).to(f32)
    kt = k.permute(0, 2, 1, 3).to(f32)              # [B, KV, Skv, dh]
    vt = v.permute(0, 2, 1, 3).to(f32)
    out = torch.empty(B, KV, G, Sq, dh, dtype=f32, device=dev)
    for q0 in range(0, Sq, q_chunk):
        q1 = min(q0 + q_chunk, Sq)
        qpos = torch.arange(q0, q1, device=dev) + q_offset
        qi = qg[:, :, :, q0:q1]
        m = torch.full((B, KV, G, q1 - q0), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, KV, G, q1 - q0, dh, dtype=f32, device=dev)
        for k0 in range(0, Skv, kv_chunk):
            k1 = min(k0 + kv_chunk, Skv)
            if causal and k0 > q1 - 1 + q_offset:
                break
            if window is not None and q0 + q_offset - (k1 - 1) >= window:
                continue
            kpos = torch.arange(k0, k1, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qi, kt[:, :, k0:k1]) * scale
            mask = None
            if causal:
                mask = qpos[:, None] >= kpos[None, :]
            if window is not None:
                wm = qpos[:, None] - kpos[None, :] < window
                mask = wm if mask is None else mask & wm
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vt[:, :, k0:k1])
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


def decode_mask(q_position, kv_positions, kv_valid,
                window: Optional[int] = None):
    """[B, 1, 1, W]: the cache entries a query at ``q_position`` [B] sees,
    by each entry's absolute position (``kv_positions`` [B, W]), not by its
    slot."""
    qp = q_position[:, None, None, None]
    kp = kv_positions[:, None, None, :]
    mask = kv_valid[:, None, None, :] & (kp <= qp)
    if window is not None:
        mask = mask & (qp - kp < window)
    return mask


def attend_cache(q, k_cache, v_cache, mask):
    """One query a row against [B, W, KV, dh] caches under ``mask``
    (:func:`decode_mask`); scores and softmax in f32."""
    B, _, H, dh = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(dh)
    f32 = torch.float32
    qg = q[:, 0].reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(f32), k_cache.to(f32)) * scale
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(f32))
    return out.reshape(B, 1, H, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, q_position, kv_positions,
                     kv_valid, window: Optional[int] = None):
    """Single-step attention against a ring KV cache, masked by each entry's
    absolute position (``kv_positions``), not by its slot.  q: [B, 1, H,
    dh]; caches: [B, W, KV, dh]."""
    return attend_cache(q, k_cache, v_cache, decode_mask(
        q_position, kv_positions, kv_valid, window))


class DecodeStep(NamedTuple):
    """What every attention layer of one decode step shares, made once a
    step (:meth:`repro_torch.models.LM.decode_step_context`): the rows, each
    row's ring slot, the rotary tables of each row's position, and the
    mask over the cache."""
    rows: torch.Tensor
    slot: torch.Tensor
    rot: tuple
    mask: torch.Tensor


# ----------------------------------------------------------------------
# GQA attention layer
# ----------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention: ``wq``, ``wk``, ``wv``, ``wo`` and, with
    ``cfg.qkv_bias``, the biases ``bq``, ``bk``, ``bv`` added after the
    product (in the compute dtype, as the reference adds them).  ``d_in``
    is ``2 * d_model`` for zamba2's shared block (concat(hidden, x0))."""

    def __init__(self, cfg, d_in=None, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = d if d_in is None else d_in
        H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
        self.cfg = cfg
        self.wq = nn.Linear(d_in, H * dh, bias=False, device=device)
        self.wk = nn.Linear(d_in, KV * dh, bias=False, device=device)
        self.wv = nn.Linear(d_in, KV * dh, bias=False, device=device)
        self.wo = nn.Linear(H * dh, d, bias=False, device=device)
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.empty(H * dh, device=device))
            self.bk = nn.Parameter(torch.empty(KV * dh, device=device))
            self.bv = nn.Parameter(torch.empty(KV * dh, device=device))

    def reset_parameters(self, generator):
        for mod in (self.wq, self.wk, self.wv, self.wo):
            init_linear(mod, generator)
        if self.cfg.qkv_bias:
            with torch.no_grad():
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()

    def qkv(self, x, rot, *, bias: bool = True):
        """Projected, biased and rotated (``rot``: :func:`rope_tables`) q, k,
        v: [B, S, heads, dh].  ``bias=False`` for the shared block's decode,
        which the reference runs without the biases."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
        q = linear(self.wq, x).reshape(B, S, H, dh)
        k = linear(self.wk, x).reshape(B, S, KV, dh)
        v = linear(self.wv, x).reshape(B, S, KV, dh)
        if cfg.qkv_bias and bias:
            q = q + self.bq.reshape(H, dh)
            k = k + self.bk.reshape(KV, dh)
            v = v + self.bv.reshape(KV, dh)
        return apply_rope(q, *rot), apply_rope(k, *rot), v

    def forward(self, x, rot, *, window=None):
        """Full-sequence attention (prefill).  x: [B, S, d_in]; ``rot`` the
        positions' rotary tables -> ([B, S, d], (k, v))."""
        B, S, _ = x.shape
        q, k, v = self.qkv(x, rot)
        out = chunked_attention(q, k, v, causal=self.cfg.causal,
                                window=window)
        return linear(self.wo, out.reshape(B, S, -1)), (k, v)

    def decode(self, x, k_cache, v_cache, step: DecodeStep, *,
               bias: bool = True):
        """One token a row.  x: [B, 1, d_in]; the row's k and v are written
        into the ring caches ([B, W, KV, dh]) at its slot, in place, before
        attending under ``step.mask`` (this step's entry included)."""
        B = x.shape[0]
        q, k, v = self.qkv(x, step.rot, bias=bias)
        k_cache[step.rows, step.slot] = k[:, 0].to(k_cache.dtype)
        v_cache[step.rows, step.slot] = v[:, 0].to(v_cache.dtype)
        a = attend_cache(q, k_cache, v_cache, step.mask)
        return linear(self.wo, a.reshape(B, 1, -1))


# ----------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU: ``(silu(x W1) * (x W3)) W2``."""

    def __init__(self, d, ff, device=None):
        super().__init__()
        self.w1 = nn.Linear(d, ff, bias=False, device=device)
        self.w3 = nn.Linear(d, ff, bias=False, device=device)
        self.w2 = nn.Linear(ff, d, bias=False, device=device)

    def reset_parameters(self, generator):
        for mod in (self.w1, self.w3, self.w2):
            init_linear(mod, generator)

    def forward(self, x):
        return linear(self.w2, F.silu(linear(self.w1, x)) * linear(self.w3, x))

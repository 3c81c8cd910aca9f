"""Full LM assembly: embedding -> blocks -> tied head (forward only).

Counterpart of the forward half of :mod:`repro.models.transformer`.
Families:
  dense / moe          pre-norm GQA attention + SwiGLU / MoE
  ssm                  Mamba2 (SSD) blocks, attention-free
  hybrid (zamba2)      Mamba2 backbone + ONE weight-shared attention+MLP
                       block invoked every ``attn_every`` layers on
                       concat(hidden, initial embedding)
  vlm / audio          stub frontend: precomputed patch/frame embeddings
                       (projected) feed the text backbone

The reference stacks its layers and scans them; here they are a
``ModuleList`` of blocks run in a loop.  :class:`LM` initializes itself
from a ``torch.Generator`` at the reference's scales (embed N(0, 0.02),
projections N(0, 1/fan_in), norms 1, biases 0, ``A_log`` 0, ``D`` 1); a
reference ``init_lm`` tree loads through
:func:`repro_torch.interop.lm_params_from_reference`.  ``lm_loss`` and
``lm_head_chunked`` (training) are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.engine import resolve_device
from .config import ModelConfig
from .layers import (MLP, Attention, DecodeStep, decode_mask,
                     init_linear, linear, rms_norm, rope_tables)
from .moe import MoE
from .ssm import Mamba2


class DenseBlock(nn.Module):
    """Pre-norm attention then SwiGLU (or MoE)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = nn.Parameter(torch.empty(d, device=device))
        self.ln2 = nn.Parameter(torch.empty(d, device=device))
        self.attn = Attention(cfg, device=device)
        if cfg.is_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(d, cfg.d_ff, device)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.ln1.fill_(1.0)
            self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        (self.moe if self.cfg.is_moe else self.mlp).reset_parameters(
            generator)

    def _ffn(self, x):
        h = rms_norm(x, self.ln2, self.cfg.norm_eps)
        return x + (self.moe(h) if self.cfg.is_moe else self.mlp(h))

    def forward(self, x, rot):
        """Full sequence: (x, (k, v)) with this layer's k and v."""
        a, kv = self.attn(rms_norm(x, self.ln1, self.cfg.norm_eps), rot,
                          window=self.cfg.swa_window)
        return self._ffn(x + a), kv

    def decode(self, x, k_cache, v_cache, step: DecodeStep):
        """One token a row; writes this layer's ring caches in place."""
        a = self.attn.decode(rms_norm(x, self.ln1, self.cfg.norm_eps),
                             k_cache, v_cache, step)
        return self._ffn(x + a)


class SSMBlock(nn.Module):
    """Pre-norm Mamba2 with a residual."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln = nn.Parameter(torch.empty(cfg.d_model, device=device))
        self.ssm = Mamba2(cfg, device)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.ln.fill_(1.0)
        self.ssm.reset_parameters(generator)

    def forward(self, x, *, return_state: bool = False):
        """x + Mamba2(norm(x)); with ``return_state`` also (h, conv)."""
        hh = rms_norm(x, self.ln, self.cfg.norm_eps)
        if return_state:
            out, hT, conv = self.ssm(hh, return_state=True)
            return x + out, (hT, conv)
        return x + self.ssm(hh), None

    def decode(self, x, h, conv_state):
        out, h, conv_state = self.ssm.decode(
            rms_norm(x, self.ln, self.cfg.norm_eps), h, conv_state)
        return x + out, h, conv_state


class SharedBlock(nn.Module):
    """Zamba2's one shared attention+MLP block on concat(hidden, x0)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = nn.Parameter(torch.empty(2 * d, device=device))
        self.ln2 = nn.Parameter(torch.empty(d, device=device))
        self.attn = Attention(cfg, d_in=2 * d, device=device)
        self.mlp = MLP(d, cfg.d_ff, device)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.ln1.fill_(1.0)
            self.ln2.fill_(1.0)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def _mlp(self, x):
        return x + self.mlp(rms_norm(x, self.ln2, self.cfg.norm_eps))

    def forward(self, x, x0, rot):
        h = rms_norm(torch.cat([x, x0], dim=-1), self.ln1, self.cfg.norm_eps)
        a, kv = self.attn(h, rot, window=self.cfg.swa_window)
        return self._mlp(x + a), kv

    def decode(self, x, x0, k_cache, v_cache, step: DecodeStep):
        """As the reference's shared-block decode, which adds no q/k/v
        bias."""
        h = rms_norm(torch.cat([x, x0], dim=-1), self.ln1, self.cfg.norm_eps)
        a = self.attn.decode(h, k_cache, v_cache, step, bias=False)
        return self._mlp(x + a)


class LM(nn.Module):
    """A language model of any family in :mod:`repro_torch.configs`.

    ``LM(cfg, device="cuda", generator=None)``: the weights are made on
    ``device`` (a CUDA device by default, which must exist; ``"cpu"`` for
    the CPU) from ``generator`` (a ``torch.Generator`` on that device;
    seeded 0 when None), in f32, as the reference keeps its master weights.
    A forward computes in the weights' dtype (:attr:`dtype`): f32 as made,
    or the compute dtype :meth:`to_compute` cast them to.
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d, L = cfg.d_model, cfg.n_layers
        meta = torch.device("meta")
        self.embed = nn.Embedding(cfg.vocab, d, device=meta)
        self.final_norm = nn.Parameter(torch.empty(d, device=meta))
        block = SSMBlock if cfg.is_ssm else DenseBlock
        self.blocks = nn.ModuleList(block(cfg, meta) for _ in range(L))
        self.shared = (SharedBlock(cfg, meta)
                       if cfg.family == "hybrid" and cfg.attn_every else None)
        self.frontend_proj = (nn.Linear(d, d, bias=False, device=meta)
                              if cfg.frontend is not None else None)
        self.to_empty(device=dev)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the weights' (but the SSM's f32 ones)."""
        return self.embed.weight.dtype

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0, generator=generator)
            self.embed.weight.mul_(0.02)
            self.final_norm.fill_(1.0)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)
        if self.frontend_proj is not None:
            init_linear(self.frontend_proj, generator)

    def to_compute(self, dtype: torch.dtype) -> "LM":
        """Make ``dtype`` the compute dtype: cast, in place, every weight
        but the SSM's :attr:`Mamba2.F32_PARAMS`.  The reference casts its f32
        master weights at every use; casting them once gives the same
        numbers."""
        for mod in self.modules():
            keep = getattr(mod, "F32_PARAMS", ())
            for name, p in mod.named_parameters(recurse=False):
                if name not in keep:
                    p.data = p.data.to(dtype)
        return self

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def rope_tables(self, positions):
        """The rotary tables every attention layer of a forward shares
        (None for an attention-free model)."""
        if not self.cfg.n_heads:
            return None
        return rope_tables(positions, self.cfg.d_head, self.cfg.rope_theta,
                           positions.device)

    def decode_step_context(self, q_pos, kv_positions) -> DecodeStep:
        """The per-step values every attention layer of a decode step
        shares: ``q_pos`` [B] the rows' positions, ``kv_positions`` [B, W]
        the ring's (this step's entries written)."""
        cfg = self.cfg
        return DecodeStep(
            rows=torch.arange(q_pos.shape[0], device=q_pos.device),
            slot=q_pos % kv_positions.shape[1],
            rot=self.rope_tables(q_pos[:, None]),
            mask=decode_mask(q_pos, kv_positions, kv_positions >= 0,
                             cfg.swa_window))

    def embed_tokens(self, tokens):
        return self.embed.weight[tokens]

    def embed_frontend(self, embeds):
        return linear(self.frontend_proj, embeds.to(self.dtype))

    def backbone(self, h, positions, *, collect_cache: bool = False):
        """h: [B, S, d] -> [B, S, d], in h's dtype.  ``collect_cache``
        returns the per-layer caches too: ``{"k": [...], "v": [...]}`` a
        layer ([B, S, KV, dh]), or ``{"ssm_h": [...], "ssm_conv": [...],
        "shared_kv": [...]}`` with one (k, v) an invocation group of the
        shared block, None for a group without its attention layer (whose
        cache rows the reference fills with zeros)."""
        cfg = self.cfg
        x = h
        rot = self.rope_tables(positions)
        if not cfg.is_ssm:
            ks, vs = [], []
            for blk in self.blocks:
                x, (k, v) = blk(x, rot)
                if collect_cache:
                    ks.append(k)
                    vs.append(v)
            return (x, {"k": ks, "v": vs}) if collect_cache else x
        ae = cfg.attn_every
        hs, convs = [], []
        shared_kv = [None] * (-(-cfg.n_layers // ae) if self.shared else 0)
        for i, blk in enumerate(self.blocks):
            x, st = blk(x, return_state=collect_cache)
            if collect_cache:
                hs.append(st[0])
                convs.append(st[1])
            if self.shared is not None and i % ae == ae - 1:
                x, shared_kv[i // ae] = self.shared(x, h, rot)
        if collect_cache:
            return x, {"ssm_h": hs, "ssm_conv": convs, "shared_kv": shared_kv}
        return x

    def lm_logits(self, x):
        """Logits at every position, f32: norm, then the tied head in the
        compute dtype."""
        hh = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return (hh @ self.embed.weight.T).to(torch.float32)

    def lm_logits_last(self, x):
        """[B, 1, V] f32 logits of the last position."""
        return self.lm_logits(x[:, -1:])

    def forward(self, tokens=None, *, embeds=None):
        """Logits at every position [B, S, V] (f32) of ``tokens`` [B, S],
        or of frontend ``embeds`` [B, S, d]."""
        h = (self.embed_frontend(embeds) if embeds is not None
             else self.embed_tokens(tokens))
        positions = torch.arange(h.shape[1], device=h.device)
        return self.lm_logits(self.backbone(h, positions))


"""Full LM assembly: embedding -> blocks -> tied head, and the LM loss.

Counterpart of :mod:`repro.models.transformer`.
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
:func:`repro_torch.interop.lm_params_from_reference`.

Training: :func:`lm_loss` runs the backbone with remat (each block under
``torch.utils.checkpoint``, as the reference checkpoints its scan body) and
:func:`lm_head_chunked`, which never holds more than one chunk's
``[B, chunk, V]`` logits.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..core.engine import resolve_device
from .config import ModelConfig
from .layers import (MLP, Attention, DecodeStep, decode_mask,
                     init_linear, linear, rms_norm, rope_tables)
from .moe import MoE
from .ssm import Mamba2


#: the products with no batch dimension: what the reference's "dots"
#: remat policy (``dots_with_no_batch_dims_saveable``) keeps.  The
#: attention and MoE einsums (``bmm``) have batch dimensions and are
#: recomputed, as there.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpointed(fn, policy: str = "full"):
    """``fn`` run under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, but, with ``policy ==
    "dots"``, the outputs of its matrix products, which are kept."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               preserve_rng_state=False, **kw)
    return run


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

    def backbone(self, h, positions, *, remat: bool = False,
                 collect_cache: bool = False):
        """h: [B, S, d] -> [B, S, d], in h's dtype.  ``remat`` runs each
        layer (an SSM block with the shared block that follows it) under
        :func:`checkpointed` with ``cfg.remat_policy``, as the reference
        checkpoints its scan body.  ``collect_cache``
        returns the per-layer caches too: ``{"k": [...], "v": [...]}`` a
        layer ([B, S, KV, dh]), or ``{"ssm_h": [...], "ssm_conv": [...],
        "shared_kv": [...]}`` with one (k, v) an invocation group of the
        shared block, None for a group without its attention layer (whose
        cache rows the reference fills with zeros)."""
        cfg = self.cfg
        rot = self.rope_tables(positions)
        ae = cfg.attn_every

        def layer(i, x, x0):
            """Layer ``i``: (x, its cache entries)."""
            blk = self.blocks[i]
            if not cfg.is_ssm:
                return blk(x, rot)
            x, st = blk(x, return_state=collect_cache)
            kv = None
            if self.shared is not None and i % ae == ae - 1:
                x, kv = self.shared(x, x0, rot)
            return x, (st, kv)

        run = checkpointed(layer, cfg.remat_policy) if remat else layer
        x = h
        outs = []
        for i in range(cfg.n_layers):
            x, out = run(i, x, h)
            if collect_cache:
                outs.append(out)
        if not collect_cache:
            return x
        if not cfg.is_ssm:
            return x, {"k": [k for k, _ in outs], "v": [v for _, v in outs]}
        shared_kv = [None] * (-(-cfg.n_layers // ae) if self.shared else 0)
        for i, (_, kv) in enumerate(outs):
            if kv is not None:
                shared_kv[i // ae] = kv
        return x, {"ssm_h": [st[0] for st, _ in outs],
                   "ssm_conv": [st[1] for st, _ in outs],
                   "shared_kv": shared_kv}

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


# ----------------------------------------------------------------------
# the reference's leaves: logical axes, and where the port holds them
# ----------------------------------------------------------------------

def reference_axes(cfg: ModelConfig) -> dict:
    """The reference ``init_lm``'s leaves by path (``"layers/attn/wq"``):
    (logical axes, shape), in the reference's own order and shape (a
    ``[d_in, d_out]`` matrix; the layer axis in front of a stacked leaf).
    A copy of the axes that the reference's ``init_lm`` and its
    ``attention_params``, ``mlp_params``, ``moe_params`` and
    ``ssm_params`` return, read by :mod:`repro_torch.dist.sharding`."""
    L, d = cfg.n_layers, cfg.d_model
    out = {"embed": (("vocab", "embed"), (cfg.vocab, d)),
           "final_norm": ((None,), (d,))}

    def leaf(path, axes, shape, stacked):
        out[path] = ((("layers",) + axes, (L,) + shape) if stacked
                     else (axes, shape))

    def attention(pre, d_in, stacked):
        H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
        leaf(pre + "wq", ("embed", "heads"), (d_in, H * dh), stacked)
        leaf(pre + "wk", ("embed", "kv"), (d_in, KV * dh), stacked)
        leaf(pre + "wv", ("embed", "kv"), (d_in, KV * dh), stacked)
        leaf(pre + "wo", ("heads", "embed"), (H * dh, d), stacked)
        if cfg.qkv_bias:
            leaf(pre + "bq", ("heads",), (H * dh,), stacked)
            leaf(pre + "bk", ("kv",), (KV * dh,), stacked)
            leaf(pre + "bv", ("kv",), (KV * dh,), stacked)

    def mlp(pre, ff, stacked):
        leaf(pre + "w1", ("embed", "ff"), (d, ff), stacked)
        leaf(pre + "w3", ("embed", "ff"), (d, ff), stacked)
        leaf(pre + "w2", ("ff", "embed"), (ff, d), stacked)

    if cfg.is_ssm:
        di, N, H, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        s = "layers/ssm/"
        leaf(s + "wz", ("embed", "ssm_inner"), (d, di), True)
        leaf(s + "wx", ("embed", "ssm_inner"), (d, di), True)
        leaf(s + "wB", ("embed", None), (d, N), True)
        leaf(s + "wC", ("embed", None), (d, N), True)
        leaf(s + "wdt", ("embed", "ssm_heads"), (d, H), True)
        for name in ("dt_bias", "A_log", "D"):
            leaf(s + name, ("ssm_heads",), (H,), True)
        leaf(s + "conv_x", (None, "ssm_inner"), (K, di), True)
        leaf(s + "conv_B", (None, None), (K, N), True)
        leaf(s + "conv_C", (None, None), (K, N), True)
        leaf(s + "norm", ("ssm_inner",), (di,), True)
        leaf(s + "out", ("ssm_inner", "embed"), (di, d), True)
        leaf("layers/ln", (None,), (d,), True)
        if cfg.family == "hybrid" and cfg.attn_every:
            attention("shared/attn/", 2 * d, False)
            mlp("shared/mlp/", cfg.d_ff, False)
            leaf("shared/ln1", (None,), (2 * d,), False)
            leaf("shared/ln2", (None,), (d,), False)
    else:
        attention("layers/attn/", d, True)
        if cfg.is_moe:
            E, ff = cfg.moe_experts, cfg.moe_d_ff
            m = "layers/moe/"
            leaf(m + "router", ("embed", None), (d, E), True)
            leaf(m + "w1", ("experts", "embed", "ff"), (E, d, ff), True)
            leaf(m + "w3", ("experts", "embed", "ff"), (E, d, ff), True)
            leaf(m + "w2", ("experts", "ff", "embed"), (E, ff, d), True)
            if cfg.moe_shared_expert:
                mlp(m + "shared/", ff, True)
        else:
            mlp("layers/mlp/", cfg.d_ff, True)
        leaf("layers/ln1", (None,), (d,), True)
        leaf("layers/ln2", (None,), (d,), True)
    if cfg.frontend is not None:
        leaf("frontend_proj", ("embed", None), (d, d), False)
    return out


class LeafSlice(NamedTuple):
    """Where a port parameter, or its ``rows`` (of dimension 0), lies in a
    reference leaf: the leaf's ``path``, the parameter's ``layer`` on the
    leaf's layer axis (None for an unstacked leaf), and for each port
    dimension the leaf dimension it is (``dims``; None for a unit
    dimension that only the port has)."""
    path: str
    layer: Optional[int]
    dims: tuple
    rows: slice = slice(None)

    def port_spec(self, spec) -> tuple:
        """The leaf's ``spec`` (one entry a leaf dimension) permuted onto
        the port's parameter.  The port holds one layer a parameter, so a
        spec that shards the layer axis raises ``ValueError``."""
        if self.layer is not None and spec[0] is not None:
            raise ValueError(f"{self.path}: the layer axis is sharded "
                             f"({spec[0]!r}), and the port holds a "
                             "parameter a layer")
        return tuple(None if d is None else spec[d] for d in self.dims)


def param_leaves(cfg: ModelConfig) -> dict:
    """Each parameter of ``LM(cfg)`` by name: the reference leaves
    (:func:`reference_axes`) it holds, as :class:`LeafSlice` s, as
    :func:`repro_torch.interop.lm_params_from_reference` carries them
    across: ``nn.Linear`` weights are the transposes of the reference's
    ``[d_in, d_out]`` matrices, and the SSM's ``conv_weight`` [C, 1, K]
    holds ``conv_x``, ``conv_B`` and ``conv_C`` ([K, C] each) in its rows."""
    out = {"embed.weight": [LeafSlice("embed", None, (0, 1))],
           "final_norm": [LeafSlice("final_norm", None, (0,))]}

    def put(name, path, layer, linear):
        n = 0 if layer is None else 1
        dims = (n + 1, n) if linear else (n,)
        out[name] = [LeafSlice(path, layer, dims)]

    def attention(name, path, layer):
        for w in ("wq", "wk", "wv", "wo"):
            put(f"{name}.{w}.weight", path + w, layer, True)
        if cfg.qkv_bias:
            for b in ("bq", "bk", "bv"):
                put(f"{name}.{b}", path + b, layer, False)

    def mlp(name, path, layer):
        for w in ("w1", "w3", "w2"):
            put(f"{name}.{w}.weight", path + w, layer, True)

    for i in range(cfg.n_layers):
        b = f"blocks.{i}"
        if cfg.is_ssm:
            put(f"{b}.ln", "layers/ln", i, False)
            for w in ("wz", "wx", "wB", "wC", "wdt", "out"):
                put(f"{b}.ssm.{w}.weight", f"layers/ssm/{w}", i, True)
            for v in ("dt_bias", "A_log", "D", "norm"):
                put(f"{b}.ssm.{v}", f"layers/ssm/{v}", i, False)
            di, N = cfg.d_inner, cfg.ssm_state
            out[f"{b}.ssm.conv_weight"] = [
                LeafSlice(f"layers/ssm/conv_{part}", i, (2, None, 1), rows)
                for part, rows in (("x", slice(0, di)),
                                   ("B", slice(di, di + N)),
                                   ("C", slice(di + N, di + 2 * N)))]
            continue
        put(f"{b}.ln1", "layers/ln1", i, False)
        put(f"{b}.ln2", "layers/ln2", i, False)
        attention(f"{b}.attn", "layers/attn/", i)
        if cfg.is_moe:
            put(f"{b}.moe.router.weight", "layers/moe/router", i, True)
            for w in ("w1", "w3", "w2"):
                out[f"{b}.moe.{w}"] = [LeafSlice(f"layers/moe/{w}", i,
                                                 (1, 2, 3))]
            if cfg.moe_shared_expert:
                mlp(f"{b}.moe.shared", "layers/moe/shared/", i)
        else:
            mlp(f"{b}.mlp", "layers/mlp/", i)
    if cfg.family == "hybrid" and cfg.attn_every:
        put("shared.ln1", "shared/ln1", None, False)
        put("shared.ln2", "shared/ln2", None, False)
        attention("shared.attn", "shared/attn/", None)
        mlp("shared.mlp", "shared/mlp/", None)
    if cfg.frontend is not None:
        put("frontend_proj.weight", "frontend_proj", None, True)
    return out


def reference_leaves(cfg: ModelConfig, names) -> list:
    """The reference's parameter leaves as groups of the port's parameter
    ``names``: a list of ``[(name, rows), ...]``, ``rows`` a slice of the
    parameter's first axis (:func:`param_leaves`).  The reference stacks
    each layer's weight across the layers into one leaf, and keeps the
    SSM's ``conv_x``, ``conv_B`` and ``conv_C`` apart where the port
    concatenates them into one ``conv_weight``; so a statistic the
    reference takes over a leaf (the int8 gradient compression's scale)
    spans a group here."""
    leaves = param_leaves(cfg)
    groups = {}
    for name in names:
        for leaf in leaves[name]:
            groups.setdefault(leaf.path, []).append((name, leaf.rows))
    return list(groups.values())


# ----------------------------------------------------------------------
# training loss
# ----------------------------------------------------------------------

def lm_head_chunked(model: LM, x, labels, *, chunk: int = 512):
    """Per-token cross-entropy, summed and divided by ``B * S``, without
    holding ``[B, S, V]`` logits: each chunk of the sequence is normed, put
    through the tied head in the compute dtype, widened to f32 and reduced
    to ``logsumexp - gold``, under :func:`checkpointed`, so the backward
    recomputes one chunk's logits at a time instead of keeping them all.
    x: [B, S, d]; labels: [B, S] (int64)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    assert S % chunk == 0, "seq must divide the loss chunk"
    eps = model.cfg.norm_eps

    def step(xc, lc, norm, emb):
        hc = rms_norm(xc, norm, eps)
        logits = (hc @ emb.T).to(torch.float32)              # [B, c, V]
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None])[..., 0]
        return torch.sum(lse - gold)

    run = checkpointed(step)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        tot = tot + run(x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                        model.final_norm, model.embed.weight)
    return tot / (B * S)


def lm_loss(model: LM, batch, *, remat: bool = True, chunk: int = 512):
    """The mean next-token cross-entropy of ``batch``: ``{"tokens": [B, S]}``
    or, for a frontend arch, ``{"embeds": [B, S, d]}``, and ``{"labels":
    [B, S]}``; tensors or arrays, moved to the model's device.  Computed in
    the model's compute dtype (:meth:`LM.to_compute`, the reference's
    ``dtype=``), the backbone under remat unless ``remat=False``, the head
    by :func:`lm_head_chunked` (``chunk``: the reference's default)."""
    dev = model.device

    def on(key, dtype=None):
        return torch.as_tensor(batch[key]).to(device=dev, dtype=dtype)

    if model.cfg.frontend is not None and "embeds" in batch:
        h = model.embed_frontend(on("embeds"))
    else:
        h = model.embed_tokens(on("tokens", torch.int64))
    positions = torch.arange(h.shape[1], device=dev)
    x = model.backbone(h, positions, remat=remat)
    return lm_head_chunked(model, x, on("labels", torch.int64), chunk=chunk)

"""Carry the reference's data across: layouts and vertex state.

For a graph system the layout and the vertex state play the part of
weights.  These helpers take the reference package's objects by duck typing
(their NumPy fields, or anything ``np.asarray`` reads, JAX arrays included)
and import nothing of it.  The reference's ``uint64`` packed
``min_with_payload`` state crosses as ``int64`` with the same bits (the
port's carrier, :func:`repro_torch.core.monoid.min_with_payload`), and
:func:`packed_to_numpy` turns it back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.engine import resolve_device
from .graph.layout import Layout

_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint32): torch.uint32, np.dtype(np.int64): torch.int64,
          np.dtype(np.bool_): torch.bool}


def layout_from_reference(layout) -> Layout:
    """A port :class:`Layout` with every field of ``layout`` (a
    ``repro.graph.layout.Layout``), arrays copied."""
    fields = {}
    for f in dataclasses.fields(Layout):
        v = getattr(layout, f.name)
        fields[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return Layout(**fields)


def to_torch(x, device="cuda") -> torch.Tensor:
    """One array (NumPy or JAX) as a tensor of the same dtype on ``device``
    (a CUDA device by default, which must exist; pass ``device="cpu"`` for
    the CPU); ``uint64`` as ``int64`` with the same bits."""
    dev = resolve_device(device)
    a = np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    if a.dtype not in _TORCH:
        raise TypeError(f"no tensor dtype for {a.dtype}")
    return torch.from_numpy(np.array(a)).to(dev)


def packed_to_numpy(t: torch.Tensor) -> np.ndarray:
    """An ``int64`` tensor of packed ``min_with_payload`` words as the
    reference's ``uint64`` NumPy array, bit for bit."""
    if t.dtype != torch.int64:
        raise TypeError(f"packed words are int64, not {t.dtype}")
    return t.cpu().numpy().view(np.uint64)


def state_to_torch(state: dict, device="cuda") -> dict:
    """A vertex-state dict of NumPy or JAX arrays as tensors on ``device``
    (as :func:`to_torch`); float32, int32, uint32, int64 and bool keep their
    types, and uint64 becomes int64 with the same bits."""
    dev = resolve_device(device)
    return {key: to_torch(v, dev) for key, v in state.items()}


def lm_params_from_reference(params, cfg) -> dict:
    """The reference's ``init_lm`` tree (nested dicts of NumPy or JAX
    arrays) as a state dict of :class:`repro_torch.models.LM` (f32 CPU
    tensors; ``load_state_dict`` moves them to the model's device).

    The layer axis of the stacked leaves is unstacked into
    ``blocks.<i>``; ``[d_in, d_out]`` matrices become ``nn.Linear``
    weights (transposed); the SSM's ``conv_x``, ``conv_B``, ``conv_C``
    ([K, C] each) become one ``conv_weight`` [C, 1, K]; MoE expert stacks
    keep the reference's layout."""
    def t(a):
        return torch.from_numpy(np.array(np.asarray(a), np.float32))

    def lin(a):
        return t(a).T.contiguous()

    def mlp(p, i=None):
        def leaf(a):
            return a if i is None else a[i]
        return {f"{n}.weight": lin(leaf(p[n])) for n in ("w1", "w3", "w2")}

    def attn(p, i=None):
        def leaf(a):
            return a if i is None else a[i]
        out = {f"{n}.weight": lin(leaf(p[n]))
               for n in ("wq", "wk", "wv", "wo")}
        out.update({n: t(leaf(p[n])) for n in ("bq", "bk", "bv") if n in p})
        return out

    def prefixed(prefix, d):
        return {f"{prefix}.{k}": v for k, v in d.items()}

    sd = {"embed.weight": t(params["embed"]),
          "final_norm": t(params["final_norm"])}
    layers = params["layers"]
    for i in range(cfg.n_layers):
        b = f"blocks.{i}"
        if "ssm" in layers:
            s = layers["ssm"]
            sd[f"{b}.ln"] = t(layers["ln"][i])
            for n in ("wz", "wx", "wB", "wC", "wdt", "out"):
                sd[f"{b}.ssm.{n}.weight"] = lin(s[n][i])
            for n in ("dt_bias", "A_log", "D", "norm"):
                sd[f"{b}.ssm.{n}"] = t(s[n][i])
            conv = np.concatenate([np.asarray(s[n][i], np.float32)
                                   for n in ("conv_x", "conv_B", "conv_C")],
                                  axis=-1)
            sd[f"{b}.ssm.conv_weight"] = t(conv.T[:, None, :])
            continue
        sd[f"{b}.ln1"] = t(layers["ln1"][i])
        sd[f"{b}.ln2"] = t(layers["ln2"][i])
        sd.update(prefixed(f"{b}.attn", attn(layers["attn"], i)))
        if "moe" in layers:
            m = layers["moe"]
            sd[f"{b}.moe.router.weight"] = lin(m["router"][i])
            for n in ("w1", "w3", "w2"):
                sd[f"{b}.moe.{n}"] = t(m[n][i])
            if "shared" in m:
                sd.update(prefixed(f"{b}.moe.shared", mlp(m["shared"], i)))
        else:
            sd.update(prefixed(f"{b}.mlp", mlp(layers["mlp"], i)))
    if "shared" in params:
        sh = params["shared"]
        sd["shared.ln1"] = t(sh["ln1"])
        sd["shared.ln2"] = t(sh["ln2"])
        sd.update(prefixed("shared.attn", attn(sh["attn"])))
        sd.update(prefixed("shared.mlp", mlp(sh["mlp"])))
    if "frontend_proj" in params:
        sd["frontend_proj.weight"] = lin(params["frontend_proj"])
    return sd

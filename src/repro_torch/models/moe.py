"""Mixture-of-Experts with PPM-powered dispatch.

Counterpart of :mod:`repro.models.moe`: token -> expert routing as
partition-centric message passing (tokens are source vertices, experts
partitions, the router's choice the frontier), with per-batch-row
capacity bins filled by a scatter and read back by a gather.  Two
dispatches, as in the reference, chosen by ``cfg.moe_impl``:

  * ``dense_dp`` (default): every rank bins every token and runs the
    experts it holds; where the layer holds only its rank's experts
    (:func:`repro_torch.dist.sharding.shard_model`) their outputs are
    gathered over the mesh's ``model`` axis.
  * ``ppm_ep``: explicit expert parallelism through the PPM bin exchange.
    Each rank of the ``model`` axis owns ``E / Dm`` experts and bins only
    its own block of tokens; the bins go to their experts' ranks with one
    ``all_to_all_single`` (the paper's Scatter), each rank runs its
    experts over every source's bins (Gather), and a second exchange
    brings the outputs back.  It runs under an active mesh
    (:func:`repro_torch.dist.sharding.set_activation_mesh`) whose
    ``model`` extent divides the experts and the sequence, and
    ``dense_dp`` runs otherwise, as in the reference; :data:`COUNTS`
    records which path each call took.

The order of bin insertion is the reference's: bin positions are taken one
top-k slot after another, so every token's first choice is placed before
any token's second choice, and the capacity drops fall on the same
(token, choice) pairs.  The capacity comes from the tokens a rank bins
(``ppm_ep``: its ``S / Dm``), so the two dispatches drop different pairs
under a mesh.  Dropped pairs go to the overflow row ``E * cap``.  Top-k
ties break toward the lower expert id, as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..dist import sharding
from .layers import MLP, init_linear, linear

#: MoE layer calls by the path they took: ``"ppm_ep"`` counts the calls that
#: exchanged bins (:func:`moe_fwd_ppm_ep_sharded`, where its conditions
#: hold), ``"dense"`` the others
COUNTS = {"ppm_ep": 0, "dense": 0}


def reset_counts():
    """Set :data:`COUNTS` to 0."""
    for key in COUNTS:
        COUNTS[key] = 0


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
        #: the experts whose weights ``w1``, ``w3`` and ``w2`` hold: all of
        #: them, or this rank's once the model is placed on a mesh
        #: (:func:`repro_torch.dist.sharding.shard_model`)
        self.local_experts = slice(0, E)

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
        return moe_fwd(self, x)


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


def capacity(cfg, S: int) -> int:
    """A bin's rows for S tokens a batch row: ``ceil(S * k / E *
    capacity)`` (1 at decode)."""
    return int(math.ceil(S * cfg.moe_top_k / cfg.moe_experts
                         * cfg.moe_capacity))


def dispatch(moe: MoE, x, cap: int):
    """Route x [B, S, d] and place each (token, choice) pair in its
    (row, expert) bin of ``cap`` slots: (flat_slot [B, S, k], keep [B, S,
    k], weights [B, S, k]); a dropped pair's slot is the overflow row
    ``E * cap``."""
    E = moe.cfg.moe_experts
    idx, wts = _route(moe, x)
    pos, keep = _dispatch_positions(idx, E, cap)
    return torch.where(keep, idx * cap + pos, E * cap), keep, wts


def _bins(x, flat_slot, E: int, cap: int):
    """Scatter tokens into bins [B, E, cap, d]; kept slots are distinct,
    dropped ones all land on the overflow row, which is cut off."""
    B, S, d = x.shape
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
    xe = torch.zeros(B, E * cap + 1, d, dtype=x.dtype, device=x.device)
    for j in range(flat_slot.shape[2]):
        xe.index_put_((rows, flat_slot[:, :, j]), x, accumulate=True)
    return xe[:, :-1].reshape(B, E, cap, d)


def _experts(xe, w1, w3, w2):
    """The expert FFN over bins [B, e, rows, d] of e experts, contiguous
    (both dispatches hand it the same layout)."""
    xe = xe.contiguous()
    h = F.silu(torch.einsum("becd,edf->becf", xe, w1)) \
        * torch.einsum("becd,edf->becf", xe, w3)
    return torch.einsum("becf,efd->becd", h, w2)


def _combine(moe: MoE, x, ye, flat_slot, keep, wts):
    """Gather each kept pair's expert output ye [B, E*cap, d] back with its
    router weight, then add the shared expert."""
    B, S, d = x.shape
    ye = torch.cat([ye, torch.zeros(B, 1, d, dtype=x.dtype,
                                    device=x.device)], 1)
    out = torch.zeros(B, S, d, dtype=x.dtype, device=x.device)
    for j in range(flat_slot.shape[2]):
        yj = ye.gather(1, flat_slot[:, :, j:j + 1].expand(B, S, d))
        out = out + yj * (wts[:, :, j] * keep[:, :, j])[..., None].to(x.dtype)
    if moe.shared is not None:
        out = out + moe.shared(x)
    return out


def _all_gather(x, group, dim: int):
    """x from every rank of ``group``, concatenated along ``dim`` in the
    group's rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _exchange(x, group):
    """One ``all_to_all_single`` over ``group``: row block r of x (dim 0)
    goes to rank r, and row block r of the result came from rank r."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_fwd_dense(moe: MoE, x):
    """DC-like dense capacity dispatch (the reference's ``moe_fwd_dense``),
    in x's dtype.  When the layer holds only its rank's experts
    (:func:`repro_torch.dist.sharding.shard_model`), each rank runs its
    experts over their bins and the outputs are gathered over the active
    mesh's ``model`` axis."""
    cfg = moe.cfg
    B, S, d = x.shape
    E = cfg.moe_experts
    COUNTS["dense"] += 1
    cap = capacity(cfg, S)
    flat_slot, keep, wts = dispatch(moe, x, cap)
    xe = _bins(x, flat_slot, E, cap)
    if moe.w1.shape[0] == E:
        ye = _experts(xe, moe.w1, moe.w3, moe.w2)
    else:
        local = moe.local_experts
        mesh = sharding._ACT_MESH[0]
        if mesh is None:
            raise ValueError("this MoE holds experts "
                             f"{local.start}-{local.stop - 1} of {E}: set "
                             "the mesh it was placed on "
                             "(sharding.set_activation_mesh)")
        ye = _all_gather(_experts(xe[:, local], moe.w1, moe.w3, moe.w2),
                         mesh.get_group("model"), 1)
    return _combine(moe, x, ye.reshape(B, E * cap, d), flat_slot, keep, wts)


def moe_fwd_ppm_ep(moe: MoE, x, group, Dm: int, m: int):
    """PPM expert-parallel dispatch on one rank's token block x [B, S, d]
    (the reference's ``moe_fwd_ppm_ep`` inside its ``shard_map``): this
    rank is ``m`` of the ``Dm`` ranks of ``group`` (the mesh's ``model``
    axis) and owns experts ``m * E_loc`` to ``(m + 1) * E_loc``.  The
    bins, of the capacity of the rank's own S tokens, go to the ranks that
    own their experts with one ``all_to_all_single`` (the paper's Scatter),
    the rank's experts run over every source rank's bins (Gather), and a
    second exchange brings the outputs back."""
    cfg = moe.cfg
    B, S, d = x.shape
    E = cfg.moe_experts
    E_loc = E // Dm
    cap = capacity(cfg, S)
    flat_slot, keep, wts = dispatch(moe, x, cap)
    xe = _bins(x, flat_slot, E, cap)
    mine = slice(m * E_loc, (m + 1) * E_loc)
    if moe.w1.shape[0] == E:
        w = [getattr(moe, n)[mine] for n in ("w1", "w3", "w2")]
    elif moe.local_experts == mine:
        w = [moe.w1, moe.w3, moe.w2]
    else:
        raise ValueError(f"ppm_ep rank {m} of {Dm} owns experts {mine}; "
                         f"this MoE holds {moe.local_experts}")

    # ---- PPM scatter: bins [Dm, B, E_loc, cap, d] to the owning ranks
    xe = _exchange(xe.reshape(B, Dm, E_loc, cap, d).transpose(0, 1), group)
    # gather phase: this rank's experts over every source rank's bins
    xe = xe.permute(1, 2, 0, 3, 4).reshape(B, E_loc, Dm * cap, d)
    ye = _experts(xe, *w)

    # ---- PPM return scatter
    ye = _exchange(ye.reshape(B, E_loc, Dm, cap, d).permute(2, 0, 1, 3, 4),
                   group)
    ye = ye.transpose(0, 1).reshape(B, E * cap, d)
    return _combine(moe, x, ye, flat_slot, keep, wts)


def local_block(x, mesh):
    """This rank's block of x [B, S, ...] under the spec (data axes,
    ``model``): batch rows by its coordinate on the data axes (the first
    named the major one), sequence by its ``model`` coordinate."""
    B, S = x.shape[:2]
    b, Db = 0, 1
    for a in sharding._data_axes(mesh):
        b = b * sharding.axis_size(mesh, a) + mesh.get_local_rank(a)
        Db *= sharding.axis_size(mesh, a)
    Dm = sharding.axis_size(mesh, "model")
    m = mesh.get_local_rank("model")
    return x[b * (B // Db):(b + 1) * (B // Db),
             m * (S // Dm):(m + 1) * (S // Dm)]


def moe_fwd_ppm_ep_sharded(moe: MoE, x):
    """The reference's ``moe_fwd_ppm_ep_sharded``: the explicit PPM
    dispatch where the active mesh
    (:func:`repro_torch.dist.sharding.set_activation_mesh`) has a
    ``model`` axis whose extent Dm divides both the experts and the
    sequence, and :func:`moe_fwd_dense` otherwise (no mesh, no ``model``
    axis, mixtral's 8 experts on 16 ranks, or a decode step's one token
    on Dm > 1).  These are the reference's semantics: the conditions pick
    the path, not a failure.

    Each rank takes its block of x under the spec (data axes, ``model``,
    None): its batch rows and ``S / Dm`` tokens, so each rank bins only
    its own tokens (:func:`local_block`); :func:`moe_fwd_ppm_ep` runs
    there, and the outputs are gathered over the ``model`` axis and then
    the data axes, so every rank holds the whole [B, S, d] as the
    reference's program does outside its ``shard_map``.  A batch that the
    data axes do not divide raises ``ValueError``, as the reference's
    ``shard_map`` refuses it."""
    cfg = moe.cfg
    mesh = sharding._ACT_MESH[0]
    if mesh is None or "model" not in sharding.axis_names(mesh) \
            or cfg.moe_experts % sharding.axis_size(mesh, "model") != 0:
        return moe_fwd_dense(moe, x)
    Dm = sharding.axis_size(mesh, "model")
    if x.shape[1] % Dm != 0:
        return moe_fwd_dense(moe, x)
    data = sharding._data_axes(mesh)
    Db = int(np.prod([sharding.axis_size(mesh, a) for a in data]))
    if x.shape[0] % Db != 0:
        raise ValueError(f"ppm_ep: batch {x.shape[0]} does not divide the "
                         f"data axes {data} (extent {Db})")
    group = mesh.get_group("model")
    y = moe_fwd_ppm_ep(moe, local_block(x, mesh), group, Dm,
                       mesh.get_local_rank("model"))
    COUNTS["ppm_ep"] += 1
    if Dm > 1:
        y = _all_gather(y, group, 1)
    for a in reversed(data):
        if sharding.axis_size(mesh, a) > 1:
            y = _all_gather(y, mesh.get_group(a), 0)
    return y


def moe_fwd(moe: MoE, x, *, impl=None):
    """The MoE layer by ``impl`` (``cfg.moe_impl`` when None):
    ``"ppm_ep"`` (:func:`moe_fwd_ppm_ep_sharded`) or the dense dispatch."""
    impl = impl or moe.cfg.moe_impl
    if impl == "ppm_ep":
        return moe_fwd_ppm_ep_sharded(moe, x)
    return moe_fwd_dense(moe, x)


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

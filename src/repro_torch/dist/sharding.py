"""Logical-axis -> mesh-axis sharding rules of the LM stack.

Counterpart of :mod:`repro.dist.sharding`.  Every parameter of an LM has a
tuple of logical axes in the reference's own order and shape
(:func:`repro_torch.models.transformer.reference_axes`: ``("embed",
"heads")`` for a ``[d_in, d_out]`` matrix, ``"layers"`` in front of a
layer-stacked leaf).  This module maps those names onto mesh axes:

  * ``default_rules(mesh, cfg)``   the rule table (FSDP data axes for
    ``embed``/``batch``, tensor-parallel ``model`` for heads/kv/ff/vocab),
    with per-config overrides via ``cfg.sharding_overrides``;
  * ``spec_for(axes, shape, ...)`` rules -> a spec (a tuple with one entry
    a dimension: a mesh axis, a tuple of them, or None) with two guards: a
    dimension that does not divide its mesh-axis extent is replicated, and
    each mesh axis is consumed at most once per tensor (the first logical
    axis mapped to it wins);
  * ``param_shardings``            the spec of every reference leaf;
  * ``batch_spec`` / ``graph_spec``  the two non-param layouts: LM batches
    over the data axes, PPM graph arrays over ALL axes flattened;
  * ``set_activation_mesh``        the mesh that model code reads at call
    time (the MoE layer's ``ppm_ep`` bin exchange);
  * ``placements``                 a spec as DTensor placements;
  * ``shard_model``                a port model placed on a mesh.

The rules read only a mesh's axis names and per-axis extents, so they take
any object with those two: a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``, and ``shape`` in axis order, from
:mod:`repro_torch.launch.mesh`), or a geometry alone with ``axis_names``
and a ``shape`` mapping from name to extent, which needs no ranks.

The reference's ``constrain`` has no counterpart: it hands XLA's
partitioner a ``with_sharding_constraint`` and returns its input
unchanged.  Eager PyTorch has no partitioner to hint; the one place where
activations move between ranks, the MoE layer's bin exchange, moves them
itself (:mod:`repro_torch.models.moe`).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# the mesh that model code reads at call time, a one-element box as in
# the reference (``_ACT_MESH[0]``)
_ACT_MESH = [None]


def set_activation_mesh(mesh):
    """Make ``mesh`` (or with ``None`` no mesh) the one that model code
    called after this reads."""
    _ACT_MESH[0] = mesh


def axis_names(mesh) -> tuple:
    """The mesh's axis names, in mesh order."""
    names = getattr(mesh, "axis_names", None)
    return tuple(mesh.mesh_dim_names if names is None else names)


def axis_size(mesh, axis: str) -> int:
    """The extent of mesh axis ``axis``."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return int(shape[axis])
    return int(shape[axis_names(mesh).index(axis)])


def _data_axes(mesh):
    """Mesh axes that carry batch-parallel / FSDP work, mesh order."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def _collapse(axes):
    """() -> None, (a,) -> a, longer tuples unchanged (a spec entry
    ``"data"`` differs from ``("data",)``, as in a PartitionSpec)."""
    if not axes:
        return None
    if isinstance(axes, str):
        return axes
    return axes[0] if len(axes) == 1 else tuple(axes)


def _flat(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def default_rules(mesh, cfg=None) -> dict:
    """Logical-axis -> mesh-axis table for ``mesh``.

    ``cfg.sharding_overrides`` (``((logical, mesh_axis_or_None), ...)``)
    rewrites individual entries (e.g. the attn-DP or expert-parallel
    variants).  Axes absent from the mesh map to None.
    """
    names = axis_names(mesh)
    data = _collapse(_data_axes(mesh))
    model = "model" if "model" in names else None
    rules = {
        "batch": data,
        "embed": data,        # FSDP: weights sharded over all data axes
        "vocab": model,
        "heads": model,
        "kv": model,
        "ff": model,
        "ssm_inner": model,
        "ssm_heads": model,
        "experts": None,      # dense_dp default: experts replicated
        "layers": None,       # the layer stack, never sharded
    }
    if cfg is not None:
        for logical, axis in getattr(cfg, "sharding_overrides", ()) or ():
            rules[logical] = axis
    return rules


def _place(assignment, dim, mesh, used):
    """One spec entry: ``assignment`` if it is a known, unconsumed mesh
    axis (or tuple) whose extent divides ``dim``, else None (replicate)."""
    if assignment is None:
        return None
    flat = _flat(assignment)
    if any(a not in axis_names(mesh) for a in flat):
        return None
    if any(a in used for a in flat):
        return None
    extent = int(np.prod([axis_size(mesh, a) for a in flat]))
    if extent <= 0 or dim % extent != 0:
        return None
    used.update(flat)
    return assignment


def spec_for(axes, shape, mesh, rules) -> tuple:
    """The spec of one tensor from its logical ``axes`` tuple.

    Guards: non-divisible dims are replicated, and each mesh axis is
    consumed at most once (first logical axis mapped to it wins).
    """
    assert len(axes) <= len(shape), \
        f"more logical axes {axes} than dims {shape}"
    used = set()
    entries = []
    for ax, dim in zip(axes, shape):
        assignment = rules.get(ax) if ax is not None else None
        entries.append(_place(assignment, int(dim), mesh, used))
    return tuple(entries)


def batch_spec(mesh) -> tuple:
    """[batch, seq] layout: batch over all data axes, seq replicated."""
    return (_collapse(_data_axes(mesh)), None)


def graph_spec(mesh) -> tuple:
    """PPM graph arrays: the device dimension over ALL mesh axes flattened
    (the bin exchange treats the pod mesh as one flat all-to-all group)."""
    return (tuple(axis_names(mesh)),)


def param_shardings(leaves: dict, mesh, rules=None) -> dict:
    """The spec of every leaf of ``leaves`` (path -> (logical axes,
    shape), as :func:`repro_torch.models.transformer.reference_axes` gives
    them), by path.  ``rules`` defaults to ``default_rules(mesh)``."""
    if rules is None:
        rules = default_rules(mesh)
    return {path: spec_for(axes, shape, mesh, rules)
            for path, (axes, shape) in leaves.items()}


def placements(spec, device_mesh) -> list:
    """``spec`` as DTensor placements on ``device_mesh``: ``Shard(dim)`` on
    every mesh dimension that tensor dimension ``dim`` takes, and
    ``Replicate()`` on the others.  A tuple entry cuts its dimension over
    several mesh dimensions, the first named the major one, as a
    PartitionSpec does; DTensor cuts a dimension in mesh order, so an entry
    that names its axes in another order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(device_mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        where = [names.index(a) for a in _flat(entry)]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry!r} cuts dimension {dim} in "
                             f"another order than the mesh's axes {names}")
        for i in where:
            out[i] = Shard(dim)
    return out


def param_specs(cfg, mesh, rules=None) -> dict:
    """Each parameter of ``LM(cfg)`` by name: the specs of the reference
    leaves it holds, one a leaf (two or more only for the SSM's
    ``conv_weight``), each permuted onto the port's tensor.  Specs are
    computed in the reference's own axis order and shape (a ``[d_in,
    d_out]`` matrix, the layer axis in front), so the guards pick the same
    winners, and then carried across (``nn.Linear`` keeps the transpose).
    ``rules`` defaults to ``default_rules(mesh, cfg)``."""
    from ..models.transformer import param_leaves, reference_axes
    if rules is None:
        rules = default_rules(mesh, cfg)
    specs = param_shardings(reference_axes(cfg), mesh, rules)
    return {name: [leaf.port_spec(specs[leaf.path]) for leaf in leaves]
            for name, leaves in param_leaves(cfg).items()}


def shard_model(model, mesh, rules=None) -> dict:
    """Place ``model`` on ``mesh`` (a ``DeviceMesh`` of this rank) by
    ``rules`` (``default_rules(mesh, model.cfg)`` when None); returns
    :func:`param_specs`.

    A MoE expert stack (``w1``, ``w3``, ``w2``) whose experts axis the
    rules put on the ``model`` axis keeps only this rank's ``E / Dm``
    experts: the local part of a ``distribute_tensor`` (taken from rank 0's
    weights), as a plain tensor; the layer records which experts it holds
    (:attr:`repro_torch.models.moe.MoE.local_experts`).  Every other weight
    is held whole on every rank: the FSDP and tensor-parallel storage that
    the rules give them is not carried out."""
    from torch.distributed.tensor import distribute_tensor
    specs = param_specs(model.cfg, mesh, rules)
    for i, blk in enumerate(getattr(model, "blocks", ())):
        moe = getattr(blk, "moe", None)
        if moe is None:
            continue
        spec = specs[f"blocks.{i}.moe.w1"][0]
        if spec[0] != "model":
            continue
        E, Dm = moe.cfg.moe_experts, axis_size(mesh, "model")
        lo = mesh.get_local_rank("model") * (E // Dm)
        with torch.no_grad():
            for name in ("w1", "w3", "w2"):
                w = getattr(moe, name)
                if w.shape[0] != E:
                    raise ValueError(f"blocks.{i}.moe.{name} holds "
                                     f"{w.shape[0]} of {E} experts: the "
                                     "model is placed already")
                local = distribute_tensor(
                    w.data, mesh, placements((spec[0],), mesh)).to_local()
                setattr(moe, name, torch.nn.Parameter(
                    local.detach().contiguous(),
                    requires_grad=w.requires_grad))
        moe.local_experts = slice(lo, lo + E // Dm)
    return specs

"""The port's sharding rules (``repro_torch.dist.sharding``), its
parameters' logical axes (``repro_torch.models.transformer``) and its LM
meshes (``repro_torch.launch.mesh``) against the reference.

The rules read only a mesh's axis names and extents, so both packages run
on the same ``jax.sharding.AbstractMesh`` geometries, with no ranks: (1,
1), (2, 2), (1, 4), (4, 1) and (16, 16) over (``data``, ``model``), and (2,
16, 16) with ``pod`` in front, with and without ``dryrun.VARIANTS``'
overrides.  Every config of ``configs.ARCHS`` at full size (the
reference's shapes through ``jax.eval_shape``):

  * ``reference_axes`` equals the reference's ``init_lm`` axes and shapes,
    leaf for leaf;
  * ``param_shardings`` equals the reference's ``param_shardings``, leaf
    for leaf, and ``param_specs`` carries each spec onto the port's
    parameter entry for entry (the permutation itself is held by value on
    the smoke configs: each port parameter is its reference leaf's layer,
    transposed where ``nn.Linear`` transposes).

Hypothesis properties mirror ``tests/test_sharding_property.py``.
``placements`` of a ``("pod", "data")`` entry cuts a tensor on 4 gloo
ranks as the reference's ``NamedSharding`` does on 4 virtual devices.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from datetime import timedelta
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

import repro.configs as ref_configs
from repro.dist import sharding as ref_sh
from repro.models import transformer as ref_tf
import repro_torch.configs as configs
from repro_torch.dist import sharding as sh
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import mesh as lmesh
from repro_torch.models import LM
from repro_torch.models.transformer import param_leaves, reference_axes
from torch_dist_ranks import Ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def _variants():
    """``dryrun.VARIANTS``' sharding overrides by name (and None: the
    config's own).  Importing ``dryrun`` sets ``XLA_FLAGS`` for 512
    devices; it is put back, as no JAX backend has started yet and
    subprocesses inherit the environment."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import VARIANTS
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    out = {name: v["sharding_overrides"] for name, v in VARIANTS.items()
           if "sharding_overrides" in v}
    assert {"attn_dp", "ep", "ppm_ep"} <= set(out)
    return dict(out, none=None)


VARIANTS = _variants()


class Cfg:
    """A stand-in config that carries only ``sharding_overrides``."""

    def __init__(self, overrides):
        self.sharding_overrides = overrides


def _mesh(i):
    shape, names = MESHES[i]
    return jax.sharding.AbstractMesh(shape, names)


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = v
    return out


def _reference(arch):
    """The reference's full-size ``init_lm``: (shapes, axes), by path."""
    cfg = ref_configs.get_config(arch)
    box = {}

    def init():
        params, box["axes"] = ref_tf.init_lm(cfg, jax.random.PRNGKey(0))
        return params
    shapes = jax.eval_shape(init)
    return shapes, box["axes"]


@pytest.fixture(scope="module")
def references():
    return {arch: _reference(arch) for arch in configs.ARCHS}


# ----------------------------------------------------------------------
# the rule table and the spec helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_default_rules_match_reference(i, variant):
    mesh, cfg = _mesh(i), Cfg(VARIANTS[variant])
    assert sh.default_rules(mesh, cfg) == ref_sh.default_rules(mesh, cfg)
    assert sh.default_rules(mesh) == ref_sh.default_rules(mesh)


AXES_CASES = [
    (("vocab", "embed"), (64, 32)), (("vocab", "embed"), (504, 32)),
    (("heads", "ff"), (8, 8)), (("embed", "heads"), (4096, 4096)),
    (("layers", "experts", "embed", "ff"), (32, 8, 4096, 14336)),
    (("layers", "experts", "ff", "embed"), (32, 16, 8192, 5120)),
    (("ssm_inner", "embed"), (3072, 1536)), ((None, "ssm_inner"), (4, 96)),
    (("batch", None), (256, 4096)), (("kv",), (3,)), ((), (5, 5)),
]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_spec_helpers_match_reference(i, variant):
    mesh = _mesh(i)
    rules = ref_sh.default_rules(mesh, Cfg(VARIANTS[variant]))
    for axes, shape in AXES_CASES:
        want = ref_sh.spec_for(axes, shape, mesh, rules)
        assert sh.spec_for(axes, shape, mesh, rules) == tuple(want), axes
    assert sh.batch_spec(mesh) == tuple(ref_sh.batch_spec(mesh))
    assert sh.graph_spec(mesh) == tuple(ref_sh.graph_spec(mesh))


# ----------------------------------------------------------------------
# every parameter of every config
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_reference_axes_match_init_lm(references, arch):
    shapes, axes = references[arch]
    want = {path: (ax, tuple(_flat(shapes)[path].shape))
            for path, ax in _flat(axes).items()}
    assert reference_axes(configs.get_config(arch)) == want


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_specs_match_reference(references, arch, i):
    """Leaf for leaf, every variant: the port's spec of each reference leaf
    is the reference's, and each port parameter's spec holds the leaf's
    entries on the dimensions ``param_leaves`` names."""
    shapes, axes = references[arch]
    mesh = _mesh(i)
    cfg = configs.get_config(arch)
    leaves = param_leaves(cfg)
    for variant, overrides in VARIANTS.items():
        rules = ref_sh.default_rules(mesh, Cfg(overrides))
        ref = {path: tuple(s.spec) for path, s in _flat(
            ref_sh.param_shardings(axes, shapes, mesh, rules)).items()}
        assert sh.param_shardings(reference_axes(cfg), mesh, rules) == ref
        got = sh.param_specs(cfg, mesh, rules)
        assert set(got) == set(leaves)
        for name, specs in got.items():
            for leaf, spec in zip(leaves[name], specs, strict=True):
                want = ref[leaf.path]
                if leaf.layer is not None:
                    assert want[0] is None
                assert spec == tuple(None if d is None else want[d]
                                     for d in leaf.dims), (variant, name)


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_leaves_hold_the_reference_leaves(arch):
    """On the smoke config, by value: each port parameter (or its rows) is
    its reference leaf's layer with the leaf's dimensions in ``dims``'
    order, and ``param_leaves`` names exactly the model's parameters."""
    rcfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(
        arch)
    params, _ = ref_tf.init_lm(rcfg, jax.random.PRNGKey(0))
    flat = _flat(params)
    port = lm_params_from_reference(params, rcfg)
    leaves = param_leaves(cfg)
    assert set(leaves) == set(port)
    assert set(leaves) == {n for n, _ in LM(cfg, device="cpu")
                           .named_parameters()}
    for name, pieces in leaves.items():
        for leaf in pieces:
            a = np.asarray(flat[leaf.path])
            if leaf.layer is not None:
                a = a[leaf.layer]
                dims = [None if d is None else d - 1 for d in leaf.dims]
            else:
                dims = list(leaf.dims)
            a = np.transpose(a, [d for d in dims if d is not None])
            for pos, d in enumerate(dims):
                if d is None:
                    a = np.expand_dims(a, pos)
            np.testing.assert_array_equal(port[name][leaf.rows].numpy(), a,
                                          err_msg=name)


def test_a_sharded_layer_axis_is_refused():
    mesh = _mesh(2)                  # (1, 4): the data axis divides
    rules = dict(ref_sh.default_rules(mesh), layers="data")
    with pytest.raises(ValueError, match="layer axis"):
        sh.param_specs(configs.get_smoke_config("qwen2-0.5b"), mesh, rules)


# ----------------------------------------------------------------------
# properties (tests/test_sharding_property.py)
# ----------------------------------------------------------------------

LOGICAL = ["vocab", "embed", "heads", "kv", "ff", "ssm_inner", "ssm_heads",
           "experts", "layers", None]
PROP_MESHES = st.sampled_from([
    ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
    ((2, 16), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
    ((2, 4, 2), ("pod", "data", "model")), ((8,), ("dev",)),
    ((1, 1), ("data", "model"))])


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_spec_for_sharded_dims_always_divide(data):
    """No entry shards a dimension that its mesh-axis extent does not
    divide, no mesh axis is consumed twice, and the spec is the
    reference's."""
    shape_axes, names = data.draw(PROP_MESHES)
    mesh = jax.sharding.AbstractMesh(shape_axes, names)
    axes = tuple(data.draw(st.sampled_from(LOGICAL))
                 for _ in range(data.draw(st.integers(1, 4))))
    shape = tuple(data.draw(st.integers(1, 96)) for _ in axes)
    rules = sh.default_rules(mesh)
    spec = sh.spec_for(axes, shape, mesh, rules)
    assert len(spec) == len(shape)
    assert spec == tuple(ref_sh.spec_for(axes, shape, mesh, rules))
    seen = set()
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        flat = (entry,) if isinstance(entry, str) else tuple(entry)
        assert dim % int(np.prod([mesh.shape[a] for a in flat])) == 0
        assert not (seen & set(flat)), f"mesh axis consumed twice: {spec}"
        seen.update(flat)


@settings(max_examples=100, deadline=None)
@given(st.data())
def test_spec_for_respects_overrides(data):
    """An override to None always replicates that logical axis."""
    shape_axes, names = data.draw(PROP_MESHES)
    mesh = jax.sharding.AbstractMesh(shape_axes, names)
    victim = data.draw(st.sampled_from([a for a in LOGICAL if a]))
    rules = sh.default_rules(mesh, Cfg(((victim, None),)))
    assert rules[victim] is None
    assert sh.spec_for((victim,), (64,), mesh, rules)[0] is None


# ----------------------------------------------------------------------
# placements: a ("pod", "data") entry cuts as NamedSharding does
# ----------------------------------------------------------------------

PLACE_SHAPE, PLACE_AXES = (2, 2, 1), ("pod", "data", "model")
PLACE_SPECS = [(("pod", "data"), None), (None, ("pod", "data")),
               ("data", "pod"), (("pod", "data"), "model"), ("pod", None)]

REFERENCE_CUTS = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import repro.dist.compat  # noqa: F401  (the JAX version shims)
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    a = pickle.loads(open(sys.argv[1], "rb").read())
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(a["shape"]),
                             a["axes"])
    coords = {d: tuple(int(c) for c in np.argwhere(mesh.devices == d)[0])
              for d in jax.devices()}
    out = {}
    for spec in a["specs"]:
        for d, idx in NamedSharding(mesh, P(*spec)).devices_indices_map(
                a["tensor"].shape).items():
            out[(spec, coords[d])] = a["tensor"][idx]
    sys.stdout.buffer.write(pickle.dumps(out))
""")


def test_placements_cut_like_named_sharding(tmp_path):
    args = dict(shape=PLACE_SHAPE, axes=PLACE_AXES, specs=PLACE_SPECS,
                tensor=np.arange(32, dtype=np.float32).reshape(8, 4))
    (tmp_path / "cuts.pkl").write_bytes(pickle.dumps(args))
    ranks = Ranks("placements", 4, tmp_path / "ranks", args)
    ref = subprocess.run(
        [sys.executable, "-c", REFERENCE_CUTS, str(tmp_path / "cuts.pkl")],
        capture_output=True, timeout=120, env=dict(
            os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert ref.returncode == 0, ref.stderr.decode()
    want = pickle.loads(ref.stdout)
    for rank in ranks.results():
        for spec in PLACE_SPECS:
            if spec == ("data", "pod"):
                continue
            np.testing.assert_array_equal(
                rank["local"][spec], want[(spec, rank["coords"])],
                err_msg=str(spec))


def test_placements_refuse_an_entry_out_of_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = jax.sharding.AbstractMesh(PLACE_SHAPE, PLACE_AXES)
    assert sh.placements((("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert sh.placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements((("data", "pod"),), mesh)


# ----------------------------------------------------------------------
# the LM meshes and placing a model, on one in-process gloo rank
# ----------------------------------------------------------------------

def test_lm_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        lmesh.make_local_mesh("cpu")


def test_lm_meshes_and_placement_on_one_gloo_rank(tmp_path):
    """``make_local_mesh`` is (1, 1) over (data, model); the refused
    pairings and sizes; ``shard_model`` under the ``ppm_ep`` variant keeps
    every expert (Dm = 1) and names each parameter's specs."""
    import dataclasses
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        mesh = lmesh.make_local_mesh("cpu")
        assert (mesh.mesh_dim_names, mesh.shape) == (("data", "model"),
                                                     (1, 1))
        assert sh.axis_names(mesh) == ("data", "model")
        assert sh.axis_size(mesh, "model") == 1
        with pytest.raises(ValueError, match="nccl"):
            lmesh.make_lm_mesh((1, 1), ("data", "model"), "cuda")
        with pytest.raises(ValueError, match="ranks"):
            lmesh.make_lm_mesh((2, 1), ("data", "model"), "cpu")
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="ranks"):
                lmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        cfg = dataclasses.replace(configs.get_smoke_config("mixtral-8x7b"),
                                  sharding_overrides=VARIANTS["ppm_ep"])
        model = LM(cfg, device="cpu")
        before = {n: p.clone() for n, p in model.named_parameters()}
        specs = sh.shard_model(model, mesh)
        assert specs == sh.param_specs(cfg, mesh)
        assert specs["blocks.0.moe.w1"] == [("model", "data", None)]
        for n, p in model.named_parameters():
            assert torch.equal(p, before[n]), n
        assert model.blocks[0].moe.local_experts == slice(0, 4)
        with pytest.raises(ValueError, match="placed already"):
            model.blocks[0].moe.w1 = torch.nn.Parameter(
                model.blocks[0].moe.w1[:2])
            sh.shard_model(model, mesh)
    finally:
        dist.destroy_process_group()

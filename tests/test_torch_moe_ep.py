"""The MoE layer's ``ppm_ep`` bin exchange (``repro_torch.models.moe``) on
gloo ranks, against the reference's ``moe_fwd(impl="ppm_ep")`` under the
same mesh.

Both sides run the reference's ``ppm_ep`` variant (``dryrun.VARIANTS``:
experts on the ``model`` axis, ``ff`` replicated, ``moe_impl="ppm_ep"``)
on the same weights (the reference's ``init_lm`` tree, carried into each
rank's placed model by ``interop.lm_params_from_reference(model=)``) and
the same seeded inputs.  The port runs on 2 and 4 gloo ranks
(``tests/torch_dist_ranks.py``'s ``moe_ep`` scenario) over the meshes (1,
2), (2, 1), (1, 4) and (2, 2) of (``data``, ``model``) and (2, 2, 1) of
(``pod``, ``data``, ``model``); the reference, in
a subprocess on 4 virtual host devices, under ``jax.jit`` with the same
mesh active.  Started at once, they run side by side.

  * Layer 0's MoE of ``mixtral-smoke`` and ``llama4-scout-smoke`` (a
    shared expert): f32 within 1e-5, bf16 within 2e-2, on every rank; the
    drop mask and slots of each rank's block equal the reference's on the
    same block, at the default capacity 1.25, where pairs drop.  The
    capacity of a rank's S / Dm tokens drops other pairs than the whole
    sequence's, so on Dm > 1 both differ from the dense dispatch.
  * The exchange ran exactly where the reference's conditions pick
    ``ppm_ep``; a batch that the data axes do not divide raises
    ``ValueError`` where the reference's ``shard_map`` refuses it; experts
    that the model axis does not divide run dense.
  * ``mixtral-smoke``'s prefill and decode steps under the mesh against
    the reference's within 1e-4: a prefill exchanges in every layer, a
    decode step's one token only where Dm = 1.
  * ``python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke
    --device cpu`` at world size 1.
"""
import math
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import transformer as ref_tf
from torch_dist_ranks import Ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
LM_ARCH = "mixtral-8x7b"
#: (data, model) meshes, and one (pod, data, model): the batch cut over
#: two data axes, pod major
SHAPES = [(1, 2), (2, 1), (1, 4), (2, 2), (2, 2, 1)]
LM_MESHES = [(2, 1), (1, 4), (2, 2), (2, 2, 1)]
#: experts that the model axis does not divide (Dm = 4): the dense path
WIDE = {"moe_experts": 6}
B, S, DECODE = 4, 16, 3
F32_ATOL, BF16_ATOL, LM_ATOL = 1e-5, 2e-2, 1e-4


def _variant():
    """``dryrun.VARIANTS["ppm_ep"]``; the module sets ``XLA_FLAGS`` for 512
    devices when imported, which is put back (nothing here has started a
    JAX backend yet, and subprocesses inherit the environment)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import VARIANTS
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dict(VARIANTS["ppm_ep"])


def _flatten(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(v, np.float32)
    return out


REFERENCE = textwrap.dedent("""
    import dataclasses, functools, math, pickle, sys
    from pathlib import Path
    import numpy as np
    import repro.dist.compat  # noqa: F401  (the JAX version shims)
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.dist.sharding import set_activation_mesh
    from repro.models import moe
    from repro.serve.engine import decode_step, init_cache, prefill
    from torch_dist_ranks import unflatten

    work = Path(sys.argv[1])
    a = pickle.loads((work / "args.pkl").read_bytes())
    x = jnp.asarray(a["x"])
    out = {}
    for arch in a["archs"]:
        cfg = dataclasses.replace(get_smoke_config(arch), **a["variant"])
        with np.load(work / f"{arch}.npz") as z:
            params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(z)))
        p0 = jax.tree_util.tree_map(lambda v: v[0], params["layers"]["moe"])
        E, k = cfg.moe_experts, cfg.moe_top_k
        for shape in a["shapes"]:
            n = int(np.prod(shape))
            mesh = jax.sharding.Mesh(
                np.array(jax.devices()[:n]).reshape(shape),
                ("pod", "data", "model")[-len(shape):])
            Db, Dm = n // shape[-1], shape[-1]
            set_activation_mesh(mesh)
            rec = {}
            for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
                fn = jax.jit(functools.partial(moe.moe_fwd, cfg=cfg, dtype=dt))
                rec[name] = np.asarray(fn(p0, x=x.astype(dt))
                                       .astype(jnp.float32))
            Bl, Sl = x.shape[0] // Db, x.shape[1] // Dm
            cap = int(np.ceil(Sl * k / E * cfg.moe_capacity))
            for b in range(Db):
                for m in range(Dm):
                    xb = x[b * Bl:(b + 1) * Bl, m * Sl:(m + 1) * Sl]
                    idx, _ = moe._route(p0, cfg, xb, jnp.float32)
                    pos, keep = moe._dispatch_positions(idx, E, cap)
                    rec[("block", b, m)] = (
                        np.asarray(keep),
                        np.asarray(jnp.where(keep, idx * cap + pos, E * cap)))
            if Db > 1:
                try:
                    jax.jit(functools.partial(moe.moe_fwd, cfg=cfg,
                                              dtype=jnp.float32))(
                        p0, x=x[:1])
                    rec["one_row"] = None
                except Exception as e:  # shard_map's divisibility check
                    rec["one_row"] = type(e).__name__
            if arch == a["lm_arch"] and shape in a["lm_meshes"]:
                toks = jnp.asarray(a["tokens"], jnp.int32)
                cache = init_cache(cfg, toks.shape[0], 32, dtype=jnp.float32)
                pf = jax.jit(functools.partial(prefill, cfg=cfg,
                                               dtype=jnp.float32))
                dc = jax.jit(functools.partial(decode_step, cfg=cfg,
                                               dtype=jnp.float32))
                lg, cache = pf(params, batch={"tokens": toks}, cache=cache)
                steps = [np.asarray(lg)]
                for t in a["next"].T:
                    lg, cache = dc(params, tokens=jnp.asarray(t, jnp.int32),
                                   cache=cache)
                    steps.append(np.asarray(lg))
                rec["lm"] = steps
            out[(arch, shape)] = rec
            set_activation_mesh(None)
    (work / "reference.pkl").write_bytes(pickle.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks (2 and 4), the reference on 4 virtual devices and
    the serve launcher, all started at once."""
    work = tmp_path_factory.mktemp("moe_ep")
    variant = _variant()
    for arch in ARCHS:
        params, _ = ref_tf.init_lm(ref_configs.get_smoke_config(arch),
                                   jax.random.PRNGKey(0))
        np.savez(work / f"{arch}.npz", **_flatten(params))
    rng = np.random.default_rng(0)
    d = ref_configs.get_smoke_config(LM_ARCH).d_model
    vocab = ref_configs.get_smoke_config(LM_ARCH).vocab
    cases = [(arch, {}, shape) for arch in ARCHS for shape in SHAPES]
    cases.append((LM_ARCH, WIDE, (1, 4)))
    args = dict(dir=str(work), archs=ARCHS, variant=variant, cases=cases,
                x=rng.standard_normal((B, S, d)).astype(np.float32),
                tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
                next=rng.integers(0, vocab, (B, DECODE)).astype(np.int32),
                lm_arch=LM_ARCH, lm_meshes=LM_MESHES, shapes=SHAPES,
                lm_cases=[(LM_ARCH, shape) for shape in LM_MESHES])
    (work / "args.pkl").write_bytes(pickle.dumps(args))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(work)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, env=env)
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH,
         "--smoke", "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    port = {w: Ranks("moe_ep", w, work / f"ranks{w}", args) for w in (2, 4)}
    try:
        out, _ = ref.communicate(timeout=240)
        assert ref.returncode == 0, out
        served, _ = launcher.communicate(timeout=240)
        assert launcher.returncode == 0, served
    finally:
        for p in (ref, launcher):
            if p.poll() is None:
                p.kill()
    return {"ref": pickle.loads((work / "reference.pkl").read_bytes()),
            "port": {w: r.results() for w, r in port.items()},
            "served": served}


def _ranks(runs, arch, shape, overrides=()):
    """Each rank's record of a case, in rank order."""
    return [rank[(arch, tuple(sorted(dict(overrides).items())), shape)]
            for rank in runs["port"][int(np.prod(shape))]]


CASES = [(arch, shape) for arch in ARCHS for shape in SHAPES]


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("arch,shape", CASES)
def test_ppm_ep_matches_reference(runs, arch, shape):
    """Every rank's MoE output (whole, gathered) against the reference's,
    f32 and bf16, and the exchange taken once a call."""
    want = runs["ref"][(arch, shape)]
    for r, rec in enumerate(_ranks(runs, arch, shape)):
        for dt, atol in (("f32", F32_ATOL), ("bf16", BF16_ATOL)):
            y, counts = rec[dt]
            assert counts == {"ppm_ep": 1, "dense": 0}, (dt, counts)
            _close(y, want[dt], atol, f"rank {r} {dt}")


@pytest.mark.parametrize("arch,shape", CASES)
def test_drop_masks_and_slots_match_reference(runs, arch, shape):
    """Each rank's block, its capacity from its own S / Dm tokens: the same
    (token, choice) pairs kept, in the same slots, as the reference's
    shard at the same coordinates; pairs do drop."""
    want = runs["ref"][(arch, shape)]
    dropped = 0
    for rec in _ranks(runs, arch, shape):
        keep, slot = want[("block",) + rec["coords"]]
        np.testing.assert_array_equal(rec["keep"].numpy(), keep)
        np.testing.assert_array_equal(rec["slot"].numpy(), slot)
        dropped += int((~keep).sum())
    assert dropped > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_expert_placement_is_the_ranks_share(runs, shape):
    """The placed layer holds its ``model`` coordinate's E / Dm experts,
    and every rank the same whole output."""
    E = ref_configs.get_smoke_config(LM_ARCH).moe_experts
    n = E // shape[-1]
    recs = _ranks(runs, LM_ARCH, shape)
    for rec in recs:
        m = rec["coords"][1]
        assert rec["local_experts"] == slice(m * n, (m + 1) * n)
        assert torch.equal(rec["f32"][0], recs[0]["f32"][0])


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (2, 2, 1)])
def test_batch_not_dividing_the_data_axes_raises(runs, shape):
    assert runs["ref"][(LM_ARCH, shape)]["one_row"] is not None
    for rec in _ranks(runs, LM_ARCH, shape):
        assert "does not divide the data axes" in rec["one_row"]


def test_experts_not_dividing_the_model_axis_run_dense(runs):
    """6 experts on Dm = 4: no exchange, the dense dispatch with its
    experts held whole on every rank, all ranks alike."""
    recs = _ranks(runs, LM_ARCH, (1, 4), WIDE)
    for rec in recs:
        y, counts = rec["f32"]
        assert counts == {"ppm_ep": 0, "dense": 1}
        assert rec["local_experts"] == slice(0, 6)
        assert torch.equal(y, recs[0]["f32"][0])


@pytest.mark.parametrize("shape", LM_MESHES)
def test_prefill_and_decode_under_the_mesh_match_reference(runs, shape):
    """The smoke LM's prefill and decode steps under the mesh, logits within
    1e-4 of the reference's on every rank.  A prefill (S = 16) exchanges
    in each layer; a decode step's one token does only on Dm = 1 (on
    Dm > 1 the dense dispatch gathers the experts' outputs)."""
    want = runs["ref"][(LM_ARCH, shape)]["lm"]
    L = ref_configs.get_smoke_config(LM_ARCH).n_layers
    for r, rec in enumerate(_ranks(runs, LM_ARCH, shape)):
        steps = rec["lm"]
        assert len(steps) == len(want) == DECODE + 1
        for i, ((lg, counts), ref) in enumerate(zip(steps, want)):
            _close(lg, ref, LM_ATOL, f"rank {r} step {i}")
            exchanged = i == 0 or shape[-1] == 1
            assert counts == ({"ppm_ep": L, "dense": 0} if exchanged
                              else {"ppm_ep": 0, "dense": L}), (i, counts)


def test_local_capacity_drops_other_pairs_than_the_dense_dispatch(runs):
    """On Dm = 4 a rank bins S / 4 tokens into ceil(S / 4 * k / E * 1.25)
    slots an expert, which sum to more than the whole sequence's
    ceil(S * k / E * 1.25): the outputs differ from Dm = 1's (the dense
    dispatch's capacity) beyond rounding, in the reference as in the
    port."""
    cfg = ref_configs.get_smoke_config(LM_ARCH)
    whole = math.ceil(S * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity)
    local = math.ceil(S // 4 * cfg.moe_top_k / cfg.moe_experts
                      * cfg.moe_capacity)
    assert 4 * local != whole
    one, four = (_ranks(runs, LM_ARCH, s)[0]["f32"][0].numpy()
                 for s in [(2, 1), (1, 4)])
    assert np.abs(one - four).max() > 1e-2


def test_serve_launcher_serves_the_moe_smoke_model_in_its_own_group(runs):
    """``launch.serve --smoke --device cpu`` on the MoE smoke config with no
    process group: it starts its own (world size 1, gloo), builds
    ``make_local_mesh`` and answers.  The config's defaults (``dense_dp``,
    experts unmapped by ``default_rules``) place no expert and exchange
    nothing, as the reference's launcher, which has no variant flag."""
    assert "[serve] 8 requests" in runs["served"], runs["served"]

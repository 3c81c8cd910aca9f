"""The port's training half (``repro_torch.models.lm_loss``,
``repro_torch.train``) on the CPU against ``repro.models.transformer`` and
``repro.train``.

Both packages start from the same weights (the reference's ``init_lm``
tree, carried across by ``interop.lm_params_from_reference``) and, where a
test says so, the same optimizer state (``interop.opt_state_from_reference``),
and see the same NumPy inputs.  f32 throughout but the bf16-master case.
Tolerances, each the reason beside it:
  * loss within 1e-5 relative, every gradient leaf within 1e-5 x its
    largest magnitude (f32 products and sums in other orders);
  * optimizer state within 1e-6 relative (atol 1e-6 x the leaf's largest
    magnitude: the same f32 operations, the library's cos and pow);
  * a 5-step trajectory of the train step within 1e-5;
  * the data pipeline array for array, checkpoints bit for bit.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as ref_configs
from repro.dist.sharding import set_activation_mesh
from repro.models import transformer as ref_tf
from repro.models.config import ModelConfig as RefConfig
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_train_step
import repro_torch.configs as configs
from repro_torch.interop import (lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models import LM, lm_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import reference_leaves
from repro_torch.train import (DataConfig, OptConfig, TokenPipeline,
                               adamw_update, checkpoint, init_opt_state,
                               lr_at, make_train_step)

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
#: the reference's train-test model (tests/test_train.py)
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv=2, d_head=16, d_ff=128, vocab=256, dtype="float32")
#: one arch of each family the loss must carry: dense, MoE, SSM, hybrid,
#: frontend
LOSS_ARCHS = ["qwen2-0.5b", "mixtral-8x7b", "mamba2-780m", "zamba2-7b",
              "pixtral-12b"]
S, CHUNK = 32, 8


def models(ref_cfg, cfg, key=KEY):
    """The reference's params (NumPy) and the port's LM with them."""
    p, _ = ref_tf.init_lm(ref_cfg, key)
    p = jax.tree.map(np.asarray, p)
    m = LM(cfg, device="cpu")
    m.load_state_dict(lm_params_from_reference(p, ref_cfg))
    return p, m


def smoke_pair(arch):
    return ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)


def lm_batch(cfg, rng, B=2, seq=S):
    toks = rng.integers(0, cfg.vocab, (B, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend is not None:
        batch["embeds"] = rng.normal(size=(B, seq, cfg.d_model)).astype(
            np.float32)
        del batch["tokens"]
    return batch


def grads_of(model, loss):
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))


def assert_grads(got: dict, want: dict, rel):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        scale = float(w.abs().max())
        err = float((got[n] - w).abs().max())
        assert err <= rel * scale, (n, err, scale)


def assert_state(got, want, rtol=1e-6):
    """Leaf for leaf within ``rtol`` (atol ``rtol`` x the leaf's largest
    magnitude)."""
    a = got.detach().to(torch.float32).numpy()
    b = want.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()))


# ----------------------------------------------------------------------
# lm_loss
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    """Loss and every gradient against ``jax.value_and_grad`` of the
    reference, f32, both with remat: for qwen2-0.5b the two ``lm_loss``
    entries at their defaults (the head's chunk min(512, S) = S); for the
    others the backbone and the chunked head at chunk 8 of S = 32."""
    rcfg, cfg = smoke_pair(arch)
    p, m = models(rcfg, cfg)
    batch = lm_batch(cfg, np.random.default_rng(0))

    def ref_loss(params, b):
        if arch == "qwen2-0.5b":
            return ref_tf.lm_loss(params, rcfg, b, dtype=jnp.float32)
        if rcfg.frontend is not None:
            h = ref_tf.embed_frontend(params, rcfg, b["embeds"], jnp.float32)
        else:
            h = ref_tf.embed_tokens(params, rcfg, b["tokens"], jnp.float32)
        x = ref_tf.backbone(params, rcfg, h, jnp.arange(S, dtype=jnp.int32),
                            dtype=jnp.float32, remat=True)
        return ref_tf.lm_head_chunked(params, rcfg, x, b["labels"],
                                      chunk=CHUNK, dtype=jnp.float32)

    want, g = jax.jit(jax.value_and_grad(ref_loss))(p, batch)
    loss = (lm_loss(m, batch) if arch == "qwen2-0.5b"
            else lm_loss(m, batch, chunk=CHUNK))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert_grads(grads_of(m, loss), lm_params_from_reference(g, rcfg), 1e-5)


class CountMM(TorchDispatchMode):
    """Counts the matrix products (``aten.mm``) dispatched under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_remat_policies_and_the_chunked_head_agree(arch):
    """No remat, full remat and the "dots" policy give the same loss and
    gradients bit for bit; the backward of full remat recomputes the
    forward's products, "dots" keeps them (as many products as without
    remat).  The chunked head agrees with full [B, S, V] logits and
    ``log_softmax`` within 1e-6 (loss) and 1e-5 x max|g| (gradients)."""
    rcfg, cfg = smoke_pair(arch)
    p, m = models(rcfg, cfg)
    batch = lm_batch(cfg, np.random.default_rng(2))
    out = {}
    for name, policy, remat in (("none", "full", False),
                                ("full", "full", True),
                                ("dots", "dots", True)):
        model = LM(dataclasses.replace(cfg, remat_policy=policy),
                   device="cpu")
        model.load_state_dict(m.state_dict())
        loss = lm_loss(model, batch, remat=remat, chunk=CHUNK)
        with CountMM() as count:
            grads = grads_of(model, loss)
        out[name] = (loss, grads, count.mm)
    for name in ("full", "dots"):
        assert torch.equal(out[name][0], out["none"][0]), name
        for n, g in out["none"][1].items():
            assert torch.equal(out[name][1][n], g), (name, n)
    assert out["dots"][2] == out["none"][2] < out["full"][2]

    tokens = torch.from_numpy(batch["tokens"]).long()
    labels = torch.from_numpy(batch["labels"]).long()
    logits = m(tokens)
    plain = -F.log_softmax(logits, -1).gather(-1, labels[..., None]).mean()
    np.testing.assert_allclose(out["none"][0].item(), plain.item(),
                               rtol=1e-6)
    assert_grads(out["none"][1], grads_of(m, plain), 1e-5)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    cfg = OptConfig(lr=1e-2, warmup=3, total_steps=12)
    rcfg = ref_opt.OptConfig(**dataclasses.asdict(cfg))
    steps = np.arange(16, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: ref_opt.lr_at(rcfg, s))(steps))
    got = lr_at(cfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


#: (compute dtype, int8_compress, clip_norm): f32 with the clip inactive,
#: the bf16-master path, and int8 error feedback with the clip active
OPT_CASES = {"f32": ("float32", False, 1e9),
             "bf16_master": ("bfloat16", False, 1.0),
             "int8_clip": ("float32", True, 1.0)}


def _grad_trees(p, rng, steps):
    """``steps`` gradient trees of ``p``'s structure, multiples of 1/64
    (|g| <= 8/64): their sums of squares are exact in f32 in any order, so
    both packages clip by the same global-norm scale (the norm is ~8, the
    clip at 1.0 active)."""
    return [jax.tree.map(lambda a: (rng.integers(-8, 9, a.shape) / 64.0)
                         .astype(np.float32), p) for _ in range(steps)]


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_matches_reference_over_three_steps(case):
    """Three ``adamw_update`` steps from ``init_opt_state`` (warmup, then
    cosine) against the reference's, and one step from each of the
    reference's states (carried across by ``opt_state_from_reference``):
    m, v, master, ef and step within 1e-6; f32 params within 1e-6, bf16
    params within one bf16 rounding (2**-8 relative: an f32 master one ulp
    apart may round to the neighbouring bf16 value).  The int8 scale spans
    each of the reference's leaves (``reference_leaves``)."""
    dtype, int8, clip = OPT_CASES[case]
    rcfg, cfg = smoke_pair("qwen2-0.5b")
    p, _ = ref_tf.init_lm(rcfg, KEY)
    p = jax.tree.map(np.asarray, p)
    ocfg = OptConfig(lr=1e-2, warmup=2, total_steps=10, clip_norm=clip,
                     int8_compress=int8, compute_dtype=dtype)
    rocfg = ref_opt.OptConfig(**dataclasses.asdict(ocfg))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    grads = _grad_trees(p, np.random.default_rng(3), 3)
    ref_update = functools.partial(ref_opt.adamw_update, cfg=rocfg)
    if not int8:
        # with int8, op by op: jitted, XLA on the CPU contracts the error
        # feedback's ``(g + ef) - q * s`` into one fused multiply-add, a
        # rounding that the reference's program does not ask for
        ref_update = jax.jit(ref_update)

    def port_params(tree):
        return {n: t.to(tdt) for n, t in
                lm_params_from_reference(tree, rcfg).items()}

    def check(params, state, rparams, rstate, metrics=None, rmetrics=None):
        want = opt_state_from_reference(rstate, rcfg)
        assert sorted(state) == sorted(want)
        assert int(state["step"]) == int(want["step"])
        for key in ("m", "v", "master", "ef"):
            for n in want.get(key, {}):
                assert_state(state[key][n], want[key][n])
        rtol = 2.0 ** -8 if tdt == torch.bfloat16 else 1e-6
        for n, w in lm_params_from_reference(rparams, rcfg).items():
            assert params[n].dtype == tdt
            assert_state(params[n], w, rtol)
        if metrics is not None:
            for k in ("lr", "grad_norm"):
                np.testing.assert_allclose(float(metrics[k]),
                                           float(rmetrics[k]), rtol=1e-6)

    rstate = ref_opt.init_opt_state(p, rocfg)
    state = init_opt_state(lm_params_from_reference(p, rcfg), ocfg)
    rparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    params = port_params(p)
    leaves = reference_leaves(cfg, list(params))
    check(params, state, rparams, rstate)
    for g in grads:
        rg = jax.tree.map(lambda a: jnp.asarray(a, dtype), g)
        pg = port_params(g)
        # one step from the reference's own state
        p1, s1 = port_params(rparams), opt_state_from_reference(rstate, rcfg)
        m1 = adamw_update(p1, pg, s1, ocfg, leaves=leaves)
        rparams, rstate, rmetrics = ref_update(rparams, rg, rstate)
        check(p1, s1, rparams, rstate, m1, rmetrics)
        # and the port's uninterrupted run
        metrics = adamw_update(params, pg, state, ocfg, leaves=leaves)
        check(params, state, rparams, rstate, metrics, rmetrics)


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_reference_leaves_are_the_references(arch):
    """``reference_leaves`` groups the port's parameters into exactly the
    reference's leaves: each reference leaf, filled with its own index and
    carried across, fills exactly one group's parts, and the parts cover
    every parameter once."""
    rcfg, cfg = smoke_pair(arch)
    shapes = jax.eval_shape(lambda: ref_tf.init_lm(rcfg, KEY)[0])
    leaves, tree = jax.tree.flatten(shapes)
    marked = jax.tree.unflatten(tree, [np.full(a.shape, i, np.float32)
                                       for i, a in enumerate(leaves)])
    port = lm_params_from_reference(marked, rcfg)
    groups = reference_leaves(cfg, list(port))
    assert len(groups) == len(leaves)
    seen = {n: torch.zeros(t.shape) for n, t in port.items()}
    ids = set()
    for group in groups:
        vals = torch.cat([port[n][rows].reshape(-1) for n, rows in group])
        assert vals.min() == vals.max(), group
        ids.add(int(vals[0]))
        for n, rows in group:
            seen[n][rows] += 1
    assert ids == set(range(len(leaves)))
    assert all(bool((c == 1).all()) for c in seen.values())


# ----------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------

@pytest.fixture
def ref_step():
    """The reference's ``make_train_step`` (microbatches 2) on a (1, 1)
    mesh, jitted; its activation mesh reset afterwards."""
    from jax.sharding import AxisType
    rcfg = RefConfig(**TINY)
    ocfg = ref_opt.OptConfig(lr=1e-3, warmup=5, total_steps=100,
                             compute_dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    try:
        step, _ = ref_train_step.make_train_step(rcfg, ocfg, mesh,
                                                 microbatches=2)
        yield rcfg, ocfg, jax.jit(step)
    finally:
        set_activation_mesh(None)


def test_train_step_matches_reference_over_five_steps(ref_step):
    """``make_train_step(microbatches=2)`` over five ``TokenPipeline``
    batches: each step's loss, lr and grad norm, and the weights and
    optimizer state after five, within 1e-5 of the reference's."""
    rcfg, rocfg, jstep = ref_step
    p, m = models(rcfg, ModelConfig(**TINY))
    ocfg = OptConfig(**dataclasses.asdict(rocfg))
    step = make_train_step(m, ocfg, microbatches=2)
    rstate = ref_opt.init_opt_state(p, rocfg)
    state = init_opt_state(m, ocfg)
    pipe = TokenPipeline(DataConfig(vocab=256, seq_len=32, global_batch=8,
                                    seed=7))
    rparams = p
    for i in range(5):
        b = pipe.batch_at(i)
        rparams, rstate, rmetrics = jstep(rparams, rstate, b)
        metrics = step(state, b)
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    for n, w in lm_params_from_reference(rparams, rcfg).items():
        np.testing.assert_allclose(m.state_dict()[n].numpy(), w.numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)
    want = opt_state_from_reference(rstate, rcfg)
    for key in ("m", "v"):
        for n, w in want[key].items():
            np.testing.assert_allclose(state[key][n].numpy(), w.numpy(),
                                       rtol=0, atol=1e-5, err_msg=n)


def test_microbatch_grads_accumulate_in_f32(monkeypatch):
    """With bf16 compute params the microbatches' gradients reach the
    optimizer as one f32 tree: their f32 sum over the count."""
    cfg = ModelConfig(**dict(TINY, dtype="bfloat16"))
    m = LM(cfg, device="cpu")
    ocfg = OptConfig(compute_dtype="bfloat16")
    state = init_opt_state(m, ocfg)
    m.to_compute(torch.bfloat16)
    seen = {}

    def spy(params, grads, st, c, **kw):
        seen.update(grads)
        return {}

    monkeypatch.setattr("repro_torch.train.train_step.adamw_update", spy)
    batch = TokenPipeline(DataConfig(vocab=256, seq_len=16,
                                     global_batch=4)).batch_at(0)
    make_train_step(m, ocfg, microbatches=2)(state, batch)
    want = {}
    for j in range(2):
        half = {k: v[2 * j:2 * j + 2] for k, v in batch.items()}
        for n, g in grads_of(m, lm_loss(m, half)).items():
            want[n] = want.get(n, 0) + g.to(torch.float32)
    for n, g in seen.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, want[n] / 2), n


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["synthetic", "memmap", "embeds"])
def test_token_pipeline_matches_reference(mode, tmp_path):
    kw = dict(vocab=97, seq_len=16, global_batch=4, seed=5)
    if mode == "memmap":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 1000, 3000).astype(
            np.int32).tofile(path)
        kw["path"] = str(path)
    if mode == "embeds":
        kw["embed_dim"] = 8
    ref = ref_data.TokenPipeline(ref_data.DataConfig(**kw))
    got = TokenPipeline(DataConfig(**kw))
    for step in (0, 1, 7, 40):
        a, b = got.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

def _trainer(seed, *, dtype="bfloat16", int8=True):
    """A tiny model (bf16 compute, f32 master, int8 feedback: every
    optimizer key), its state and its step."""
    cfg = ModelConfig(**dict(TINY, dtype=dtype))
    m = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    ocfg = OptConfig(lr=1e-3, warmup=2, total_steps=20, int8_compress=int8,
                     compute_dtype=dtype)
    state = init_opt_state(m, ocfg)
    if dtype == "bfloat16":
        m.to_compute(torch.bfloat16)
    return m, state, make_train_step(m, ocfg, microbatches=2)


def _batches():
    pipe = TokenPipeline(DataConfig(vocab=256, seq_len=16, global_batch=4,
                                    seed=1))
    return [pipe.batch_at(i) for i in range(4)]


def _leaves(m, state):
    return dict(m.state_dict(), **{
        f"{k}/{n}": t for k, tree in state.items()
        for n, t in (tree.items() if isinstance(tree, dict)
                     else [("", tree)])})


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_checkpoint_round_trip_in_the_reference_format(tmp_path):
    """Every param and optimizer leaf back bit for bit in a model and state
    made from another seed; the files are the reference's: one npz of
    ``p_i`` / ``o_i`` leaves (bf16 as uint16 bits), a manifest, LATEST."""
    m, state, step = _trainer(0)
    step(state, _batches()[0])
    path = str(tmp_path / "ck")
    checkpoint.save(path, 1, m, state, extra={"note": "x"})
    m2, state2, _ = _trainer(1)
    got_state, got_step = checkpoint.restore(path, m2, state2)
    assert got_step == 1 and got_state is state2
    _assert_same(_leaves(m2, state2), _leaves(m, state))
    assert sorted(os.listdir(path)) == ["LATEST", "ckpt_00000001.json",
                                        "ckpt_00000001.npz"]
    man = json.loads((tmp_path / "ck" / "ckpt_00000001.json").read_text())
    n_p = len(m.state_dict())
    assert (man["step"], man["n_params"], man["extra"]) == (1, n_p,
                                                            {"note": "x"})
    # params in state_dict order, then ef, m, master, step, v
    assert man["n_opt"] == 4 * n_p + 1
    data = np.load(tmp_path / "ck" / "ckpt_00000001.npz")
    assert sorted(data.files) == sorted(
        [f"p_{i}" for i in range(n_p)]
        + [f"o_{i}" for i in range(man["n_opt"])])
    first = next(iter(m.state_dict().values()))
    assert data["p_0"].dtype == np.uint16 and man["dtypes"][0] == "bfloat16"
    assert torch.equal(torch.from_numpy(data["p_0"].astype(np.int32)),
                       first.view(torch.int16).to(torch.int32) & 0xFFFF)
    np.testing.assert_array_equal(data[f"o_{3 * n_p}"],
                                  state["step"].numpy())
    np.testing.assert_array_equal(data[f"o_{n_p}"],
                                  next(iter(state["m"].values())).numpy())


def test_resume_is_bit_exact(tmp_path):
    """Four steps straight against two, a checkpoint, a restore into a
    fresh model and state, and two more: the same losses and leaves."""
    batches = _batches()
    m, state, step = _trainer(0)
    straight = [float(step(state, b)["loss"]) for b in batches]
    m1, s1, step1 = _trainer(0)
    first = [float(step1(s1, b)["loss"]) for b in batches[:2]]
    checkpoint.save(str(tmp_path), 2, m1, s1)
    m2, s2, step2 = _trainer(1)
    assert checkpoint.restore(str(tmp_path), m2, s2)[1] == 2
    rest = [float(step2(s2, b)["loss"]) for b in batches[2:]]
    assert first + rest == straight
    _assert_same(_leaves(m2, s2), _leaves(m, state))


def test_failed_save_leaves_the_latest_checkpoint(tmp_path, monkeypatch):
    """A save that dies while writing its npz commits nothing: LATEST and
    the previous checkpoint stand, and it restores."""
    m, state, step = _trainer(0)
    path = str(tmp_path)
    checkpoint.save(path, 1, m, state)
    want = {k: v.clone() for k, v in _leaves(m, state).items()}
    step(state, _batches()[0])

    def boom(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save(path, 2, m, state)
    monkeypatch.undo()
    assert checkpoint.latest_step(path) == 1
    assert not (tmp_path / "ckpt_00000002.npz").exists()
    assert not (tmp_path / "ckpt_00000002.json").exists()
    m2, s2, _ = _trainer(1)
    checkpoint.restore(path, m2, s2)
    _assert_same(_leaves(m2, s2), want)


def test_restore_refuses_another_model(tmp_path):
    m, state, _ = _trainer(0)
    checkpoint.save(str(tmp_path), 3, m, state)
    other = LM(ModelConfig(**dict(TINY, d_ff=96)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), other)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), m)


def test_async_checkpointer_snapshots_at_save(tmp_path):
    """The async save holds the leaves as they were when it was called,
    whatever training does to the tensors meanwhile; a failed write is
    raised by ``wait``."""
    m, state, step = _trainer(0)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path / "ck"))
    want = {k: v.clone() for k, v in _leaves(m, state).items()}
    ck.save(1, m, state)
    step(state, _batches()[0])                 # rewrites in place
    ck.save(2, m, state)                       # waits for the first
    ck.wait()
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 2
    m2, s2, _ = _trainer(1)
    checkpoint.restore(str(tmp_path / "ck"), m2, s2, step=1)
    _assert_same(_leaves(m2, s2), want)
    (tmp_path / "file").write_text("")
    bad = checkpoint.AsyncCheckpointer(str(tmp_path / "file"))
    bad.save(1, m, state)
    with pytest.raises(OSError):
        bad.wait()

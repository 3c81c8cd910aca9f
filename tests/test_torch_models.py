"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``) on
the CPU against ``repro.models`` / ``repro.configs``.

Both packages get the same inputs from seeded NumPy and the same weights:
the reference's ``init_lm`` tree, carried across by
``repro_torch.interop.lm_params_from_reference``.  f32 throughout except
where a test says otherwise.  Tolerances: the layers within 1e-5 (f32
rounding of products summed in another order); whole models within 1e-4,
the reference's own tolerance for prefill + decode against the full
forward (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import test_models
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.config import ModelConfig as RefConfig
import repro_torch.configs as configs
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import LM, layers, moe, ssm
from repro_torch.models.config import ModelConfig

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)

#: the five model-stack configurations of tests/test_models.py, as fields
CFGS = {name: dataclasses.asdict(cfg)
        for name, cfg in test_models.CFGS.items()}
ALL = [("cfg", n) for n in CFGS] + [("smoke", a) for a in configs.ARCHS]


def config_pair(kind, name):
    """(reference config, port config) of a CFGS entry or a smoke arch."""
    if kind == "cfg":
        return RefConfig(**CFGS[name]), ModelConfig(**CFGS[name])
    return (ref_configs.get_smoke_config(name),
            configs.get_smoke_config(name))


def models(ref_cfg, cfg, key=KEY):
    """The reference's params (NumPy) and the port's LM with them."""
    p, _ = ref_tf.init_lm(ref_cfg, key)
    p = jax.tree.map(np.asarray, p)
    m = LM(cfg, device="cpu")
    m.load_state_dict(lm_params_from_reference(p, ref_cfg))
    return p, m


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got)
                               else got, np.asarray(want), rtol=0, atol=atol)


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_configs_are_the_references(arch):
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(ref_configs, get)(arch)
        got = getattr(configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.param_count() == ref.param_count()
        assert got.active_param_count() == ref.active_param_count()
        assert (got.d_inner, got.ssm_heads, got.sub_quadratic()) == \
            (ref.d_inner, ref.ssm_heads, ref.sub_quadratic())


def test_shape_table_and_cells_are_the_references():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.SHAPES == ref_configs.SHAPES
    assert list(configs.all_cells()) == list(ref_configs.all_cells())


def test_qwen2_full_width_param_count():
    cfg = configs.get_config("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head,
            cfg.d_ff, cfg.vocab, cfg.qkv_bias, cfg.rope_theta) == \
        (24, 896, 14, 2, 64, 4864, 151936, True, 1e6)
    assert 490e6 < cfg.param_count() < 500e6


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    w = rng.normal(size=16).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_layers.rms_norm(jnp.asarray(x, jd), jnp.asarray(w), 1e-5)
    got = layers.rms_norm(t(x).to(td), t(w), 1e-5)
    assert got.dtype == td
    # bf16: both cast the scale and the weight to bf16 before each multiply
    close(got.float(), np.asarray(want, np.float32),
          1e-6 if dtype == "float32" else 0.0)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 50
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(layers.rope(t(x), t(pos), theta), want, 1e-5)
    # decode form: one position a row
    qpos = np.array([3, 90], np.int32)
    want = ref_layers.rope(jnp.asarray(x[:, :1]), jnp.asarray(qpos)[:, None],
                           theta)
    close(layers.rope(t(x[:, :1]), t(qpos)[:, None], theta), want, 1e-5)


@pytest.mark.parametrize("window", [None, 5, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(4, 4), (5, 3), (1024, 1024)])
def test_chunked_attention(window, causal, chunks):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 13, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 13, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 13, 2, 8)).astype(np.float32)
    qc, kc = chunks
    want = ref_layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=qc, kv_chunk=kc)
    got = layers.chunked_attention(t(q), t(k), t(v), causal=causal,
                                   window=window, q_chunk=qc, kv_chunk=kc)
    close(got, want, 1e-5)


def test_chunked_attention_with_offset_and_bf16():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 6, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 10, 4, 8)).astype(np.float32)
    v = rng.normal(size=(1, 10, 4, 8)).astype(np.float32)
    want = ref_layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=3,
        q_offset=4, q_chunk=2, kv_chunk=3)
    got = layers.chunked_attention(t(q), t(k), t(v), window=3, q_offset=4,
                                   q_chunk=2, kv_chunk=3)
    close(got, want, 1e-5)
    # bf16 inputs: scores in f32, one rounding of the output (1 bf16 ulp)
    want = ref_layers.chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = layers.chunked_attention(*(t(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), 2 ** -7)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_masks_by_ring_positions(window):
    rng = np.random.default_rng(5)
    B, W, KV, H, dh = 3, 8, 2, 4, 8
    q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
    kc = rng.normal(size=(B, W, KV, dh)).astype(np.float32)
    vc = rng.normal(size=(B, W, KV, dh)).astype(np.float32)
    # a wrapped ring (row 0), a partly empty one (row 1), a full one (row 2)
    pos = np.array([[8, 9, 10, 11, 4, 5, 6, 7],
                    [0, 1, 2, -1, -1, -1, -1, -1],
                    [0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
    qp = np.array([11, 2, 5], np.int32)
    want = ref_layers.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        q_position=jnp.asarray(qp), kv_positions=jnp.asarray(pos),
        kv_valid=jnp.asarray(pos >= 0), window=window)
    got = layers.decode_attention(t(q), t(kc), t(vc), q_position=t(qp),
                                  kv_positions=t(pos), kv_valid=t(pos >= 0),
                                  window=window)
    close(got, want, 1e-5)


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------

def moe_pair(ref_cfg, cfg, key=1):
    """The reference's MoE params and the port's MoE with them (the
    layer-0 block of a one-layer LM state dict)."""
    p, _ = ref_moe.moe_params(jax.random.PRNGKey(key), ref_cfg)
    p = jax.tree.map(np.asarray, p)
    mod = moe.MoE(cfg)
    sd = {"router.weight": t(p["router"]).T.contiguous(),
          "w1": t(p["w1"]), "w3": t(p["w3"]), "w2": t(p["w2"])}
    if cfg.moe_shared_expert:
        for n in ("w1", "w3", "w2"):
            sd[f"shared.{n}.weight"] = t(p["shared"][n]).T.contiguous()
    mod.load_state_dict(sd)
    return p, mod


@pytest.mark.parametrize("shared", [True, False])
def test_moe_matches_reference_and_oracle(shared):
    kw = dict(CFGS["moe"], moe_shared_expert=shared)
    ref_cfg, cfg = RefConfig(**kw), ModelConfig(**kw)
    p, mod = moe_pair(ref_cfg, cfg)
    x = np.random.default_rng(6).normal(size=(2, 8, 32)).astype(np.float32)
    want = ref_moe.moe_fwd_dense(p, ref_cfg, jnp.asarray(x),
                                 dtype=jnp.float32)
    with torch.no_grad():
        got = moe.moe_fwd_dense(mod, t(x))
        close(got, want, 1e-5)
        close(moe.moe_ref(mod, t(x)), ref_moe.moe_ref(p, ref_cfg,
                                                      jnp.asarray(x)), 1e-5)
        close(got, moe.moe_ref(mod, t(x)), 1e-5)


@pytest.mark.parametrize("top_k,capacity", [(2, 0.25), (2, 0.5), (1, 0.5)])
def test_moe_capacity_drops_match_reference(top_k, capacity):
    """Dropped (token, choice) pairs are the reference's: first choices are
    placed before any second choice."""
    kw = dict(CFGS["moe"], moe_top_k=top_k, moe_capacity=capacity)
    ref_cfg, cfg = RefConfig(**kw), ModelConfig(**kw)
    p, mod = moe_pair(ref_cfg, cfg)
    x = np.random.default_rng(7).normal(size=(2, 16, 32)).astype(np.float32)
    idx, _ = ref_moe._route(p, ref_cfg, jnp.asarray(x), jnp.float32)
    cap = int(np.ceil(16 * top_k / 4 * capacity))
    pos, keep = ref_moe._dispatch_positions(idx, 4, cap)
    with torch.no_grad():
        pidx, _ = moe._route(mod, t(x))
        ppos, pkeep = moe._dispatch_positions(pidx, 4, cap)
        got = moe.moe_fwd_dense(mod, t(x))
    assert np.array_equal(pidx.numpy(), np.asarray(idx))
    assert np.array_equal(ppos.numpy(), np.asarray(pos))
    assert np.array_equal(pkeep.numpy(), np.asarray(keep))
    assert not pkeep.all()
    want = ref_moe.moe_fwd_dense(p, ref_cfg, jnp.asarray(x),
                                 dtype=jnp.float32)
    close(got, want, 1e-5)
    assert torch.isfinite(got).all()


def test_moe_decode_capacity_is_one():
    """S = 1 gives cap = ceil(k / E * capacity) = 1: both choices kept."""
    ref_cfg, cfg = RefConfig(**CFGS["moe"]), ModelConfig(**CFGS["moe"])
    p, mod = moe_pair(ref_cfg, cfg)
    x = np.random.default_rng(8).normal(size=(3, 1, 32)).astype(np.float32)
    with torch.no_grad():
        close(moe.moe_fwd_dense(mod, t(x)),
              ref_moe.moe_fwd_dense(p, ref_cfg, jnp.asarray(x),
                                    dtype=jnp.float32), 1e-5)


def test_router_ties_break_to_the_lower_expert():
    cfg = ModelConfig(**dict(CFGS["moe"], moe_shared_expert=False))
    mod = moe.MoE(cfg)
    with torch.no_grad():
        mod.router.weight.zero_()          # every logit equal
        idx, w = moe._route(mod, torch.ones(1, 3, 32))
    assert idx.tolist() == [[[0, 1]] * 3]
    assert torch.equal(w, torch.full((1, 3, 2), 0.5))


# ----------------------------------------------------------------------
# SSM
# ----------------------------------------------------------------------

def ssd_inputs(seed=9):
    rng = np.random.default_rng(seed)
    B, L, H, P, N = 2, 24, 3, 4, 8
    return dict(
        x=rng.normal(size=(B, L, H, P)).astype(np.float32),
        dt=rng.random((B, L, H)).astype(np.float32) * 0.5,
        A=-rng.random(H).astype(np.float32),
        B=rng.normal(size=(B, L, N)).astype(np.float32),
        C=rng.normal(size=(B, L, N)).astype(np.float32),
        D=rng.random(H).astype(np.float32),
        h0=rng.normal(size=(B, H, N, P)).astype(np.float32) * .1)


@pytest.mark.parametrize("chunk", [1, 5, 8, 24, 32])
def test_ssd_chunked_matches_sequential_and_reference(chunk):
    a = ssd_inputs()
    ta = {k: t(v) for k, v in a.items()}
    y1, h1 = ssm.ssd_chunked(ta["x"], ta["dt"], ta["A"], ta["B"], ta["C"],
                             ta["D"], chunk=chunk, h0=ta["h0"])
    y2, h2 = ssm.ssd_sequential_ref(ta["x"], ta["dt"], ta["A"], ta["B"],
                                    ta["C"], ta["D"], h0=ta["h0"])
    close(y1, y2, 1e-4)
    close(h1, h2, 1e-4)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    y3, h3 = ref_ssm.ssd_chunked(ja["x"], ja["dt"], ja["A"], ja["B"],
                                 ja["C"], ja["D"], chunk=chunk, h0=ja["h0"])
    close(y1, y3, 1e-5)
    close(h1, h3, 1e-5)
    y4, h4 = ref_ssm.ssd_sequential_ref(ja["x"], ja["dt"], ja["A"], ja["B"],
                                        ja["C"], ja["D"], h0=ja["h0"])
    close(y2, y4, 1e-5)
    close(h2, h4, 1e-5)


def test_causal_conv_is_the_references():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    want = ref_ssm.causal_conv(jnp.asarray(x), jnp.asarray(w))
    close(ssm.causal_conv(t(x), t(w.T[:, None, :].copy())), want, 1e-6)


def test_mamba2_block_and_decode_match_reference():
    ref_cfg, cfg = RefConfig(**CFGS["ssm"]), ModelConfig(**CFGS["ssm"])
    p, m = models(ref_cfg, cfg)
    pl = jax.tree.map(lambda a: a[0], p["layers"]["ssm"])
    blk = m.blocks[0].ssm
    x = np.random.default_rng(11).normal(size=(2, 10, 32)).astype(np.float32)
    out, hT, conv = ref_ssm.ssm_block_fwd(pl, ref_cfg, jnp.asarray(x),
                                          dtype=jnp.float32,
                                          return_state=True)
    with torch.no_grad():
        pout, phT, pconv = blk(t(x), return_state=True)
        close(pout, out, 1e-5)
        close(phT, hT, 1e-5)
        close(pconv, conv, 1e-6)
        x1 = x[:, :1] * 2
        want = ref_ssm.ssm_block_decode(pl, ref_cfg, jnp.asarray(x1), hT,
                                        conv, dtype=jnp.float32)
        got = blk.decode(t(x1), phT, pconv)
    for g, w in zip(got, want):
        close(g, w, 1e-5)


def test_prefill_shorter_than_the_conv_state_raises():
    cfg = ModelConfig(**CFGS["ssm"])
    m = LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="conv state"):
        m.blocks[0].ssm(torch.zeros(1, cfg.ssm_conv - 2, 32),
                        return_state=True)


# ----------------------------------------------------------------------
# whole models
# ----------------------------------------------------------------------

def ref_inputs(ref_cfg, S, seed):
    rng = np.random.default_rng(seed)
    if ref_cfg.frontend is not None:
        return {"embeds": rng.normal(size=(2, S, ref_cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, ref_cfg.vocab, (2, S))
            .astype(np.int32)}


def embed_both(p, ref_cfg, m, inputs, jd=jnp.float32):
    if "embeds" in inputs:
        e = inputs["embeds"]
        return (ref_tf.embed_frontend(p, ref_cfg, jnp.asarray(e), jd),
                m.embed_frontend(t(e)))
    tok = inputs["tokens"]
    return (ref_tf.embed_tokens(p, ref_cfg, jnp.asarray(tok), jd),
            m.embed_tokens(t(tok).long()))


@pytest.mark.parametrize("kind,name", ALL)
def test_backbone_and_last_logits_match_reference(kind, name):
    ref_cfg, cfg = config_pair(kind, name)
    p, m = models(ref_cfg, cfg)
    S = 20
    inputs = ref_inputs(ref_cfg, S, seed=12)
    h, th = embed_both(p, ref_cfg, m, inputs)
    x = ref_tf.backbone(p, ref_cfg, h, jnp.arange(S), dtype=jnp.float32,
                        remat=False)
    with torch.no_grad():
        tx = m.backbone(th, torch.arange(S))
        close(tx, x, 1e-4)
        close(m.lm_logits_last(tx),
              ref_tf.lm_logits_last(p, ref_cfg, x, jnp.float32), 1e-4)


def test_encoder_attention_not_causal():
    """hubert-style encoder: token t attends to t' > t."""
    cfg = ModelConfig(name="enc", family="audio", n_layers=1, d_model=16,
                      n_heads=2, n_kv=2, d_head=8, d_ff=32, vocab=16,
                      causal=False, frontend="frame", dtype="float32")
    m = LM(cfg, device="cpu")
    e = torch.from_numpy(np.random.default_rng(13).normal(size=(1, 8, 16))
                         .astype(np.float32))
    e2 = e.clone()
    e2[0, -1] += 1.0
    with torch.no_grad():
        out1 = m.backbone(m.embed_frontend(e), torch.arange(8))
        out2 = m.backbone(m.embed_frontend(e2), torch.arange(8))
    assert float((out1[0, 0] - out2[0, 0]).abs().max()) > 1e-6


def test_bf16_backbone_close_to_reference():
    """bf16 compute (the reference casts f32 master weights at every use;
    the port casts them once): within 2e-2 of the reference's bf16 logits.
    These logits have a std of 0.17 and a largest magnitude of 0.71, where
    a bf16 ulp is 2**-8; the two packages differ by 7.8e-3 (two ulps, the
    products summed in other orders), and the limit is 2.5 times that."""
    ref_cfg, cfg = config_pair("smoke", "qwen2-0.5b")
    p, m = models(ref_cfg, cfg)
    inputs = ref_inputs(ref_cfg, 16, seed=14)
    m.to_compute(torch.bfloat16)
    h, th = embed_both(p, ref_cfg, m, inputs, jnp.bfloat16)
    x = ref_tf.backbone(p, ref_cfg, h, jnp.arange(16), dtype=jnp.bfloat16,
                        remat=False)
    want = ref_tf.lm_logits_last(p, ref_cfg, x, jnp.bfloat16)
    with torch.no_grad():
        tx = m.backbone(th, torch.arange(16))
    assert tx.dtype == torch.bfloat16
    got = m.lm_logits_last(tx)
    close(got, want, 2e-2)


@pytest.mark.parametrize("kind,name", [("cfg", "ssm"), ("cfg", "hybrid"),
                                       ("smoke", "mamba2-780m")])
def test_to_compute_keeps_the_ssm_f32_params(kind, name):
    _, cfg = config_pair(kind, name)
    m = LM(cfg, device="cpu").to_compute(torch.bfloat16)
    for pname, prm in m.named_parameters():
        leaf = pname.rsplit(".", 1)[-1]
        want = (torch.float32 if leaf in ssm.Mamba2.F32_PARAMS
                else torch.bfloat16)
        assert prm.dtype == want, pname


@pytest.mark.parametrize("kind,name", [("cfg", "dense"), ("cfg", "moe"),
                                       ("cfg", "hybrid"),
                                       ("smoke", "pixtral-12b")])
def test_port_init_scales(kind, name):
    """The port's own initialization at the reference's scales."""
    _, cfg = config_pair(kind, name)
    gen = torch.Generator().manual_seed(0)
    m = LM(cfg, device="cpu", generator=gen)
    sd = m.state_dict()
    assert abs(float(sd["embed.weight"].std()) - 0.02) < 0.002
    for key, val in sd.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("ln", "ln1", "ln2", "final_norm", "norm", "D"):
            assert torch.all(val == 1), key
        elif leaf in ("bq", "bk", "bv", "dt_bias", "A_log"):
            assert torch.all(val == 0), key
        elif key.endswith(".weight") and val.dim() == 2 \
                and key != "embed.weight":
            fan_in = val.shape[1]
            assert abs(float(val.std()) * np.sqrt(fan_in) - 1) < 0.15, key
    # a second model from the same seed is the same model
    m2 = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(sd.values(), m2.state_dict().values()))


@pytest.mark.parametrize("kind,name", ALL)
def test_state_dict_from_reference_is_complete(kind, name):
    ref_cfg, cfg = config_pair(kind, name)
    p, _ = ref_tf.init_lm(ref_cfg, KEY)
    sd = lm_params_from_reference(jax.tree.map(np.asarray, p), ref_cfg)
    want = LM(cfg, device="cpu").state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(p))
    assert sum(v.numel() for v in sd.values()) == n_ref

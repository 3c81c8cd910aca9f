"""The port's LM serving path (``repro_torch.serve``: caches, prefill,
decode, the slot ``Server``; ``repro_torch.launch.serve``) on the CPU
against ``repro.serve.engine``.

Same weights on both sides (the reference's ``init_lm`` tree through
``repro_torch.interop.lm_params_from_reference``) and the same seeded NumPy
prompts.  In f32, prefill followed by decode must give the full forward's
logits at every position within 1e-4 (the reference's own tolerance,
``tests/test_models.py``), and the reference's prefill/decode logits within
the same; the servers must return the same greedy tokens.  One bf16 case
holds decode to the port's own bf16 full forward within two bf16 ulps of
its largest logits (:func:`test_bf16_decode_close_to_full_forward`).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import engine as ref_serve
import repro_torch.configs as configs
from repro_torch.models import LM
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (Request, Server, decode_step, init_cache,
                               prefill)
from repro_torch.serve import engine as serve
from test_torch_models import CFGS, config_pair, models

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DECODERS = [a for a in configs.ARCHS if configs.get_config(a).decoder]


def close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def run_both(kind, name, S, extra, max_len=64, seed=0):
    """Prefill S positions then decode ``extra`` in both packages; returns
    the reference's logits, the port's and the port's full forward."""
    ref_cfg, cfg = config_pair(kind, name)
    p, m = models(ref_cfg, cfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, ref_cfg.vocab, (2, S + extra)).astype(np.int32)
    first = {"tokens": toks[:, :S]}
    if ref_cfg.frontend is not None:
        first = {"embeds": rng.normal(size=(2, S, ref_cfg.d_model))
                 .astype(np.float32)}
    cache = ref_serve.init_cache(ref_cfg, 2, max_len, dtype=jnp.float32)
    lg, cache = ref_serve.prefill(
        p, ref_cfg, {k: jnp.asarray(v) for k, v in first.items()}, cache,
        dtype=jnp.float32)
    ref = [np.asarray(lg)]
    for i in range(extra):
        lg, cache = ref_serve.decode_step(p, ref_cfg,
                                          jnp.asarray(toks[:, S + i]), cache,
                                          dtype=jnp.float32)
        ref.append(np.asarray(lg))
    tt = torch.from_numpy(toks).long()
    pc = init_cache(cfg, 2, max_len, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        lg, pc = prefill(m, {k: torch.from_numpy(v).long() if k == "tokens"
                             else torch.from_numpy(v)
                             for k, v in first.items()}, pc)
        got = [lg]
        for i in range(extra):
            lg, pc = decode_step(m, tt[:, S + i], pc)
            got.append(lg)
        full = None
        if "tokens" in first:
            full = m(tt)[:, S - 1:]
    assert int(pc["len"][0]) == S + extra
    return ref, got, full


@pytest.mark.parametrize("name", list(CFGS))
def test_decode_equals_full_forward(name):
    """Per family, f32: the port's prefill + decode against its own full
    forward and against the reference's prefill + decode, 1e-4.  The swa
    case prefills 12 positions into a window of 6 (the ring wraps)."""
    ref, got, full = run_both("cfg", name, S=12, extra=3)
    for i, (r, g) in enumerate(zip(ref, got)):
        close(g, r, 1e-4)
        close(g, full[:, i], 1e-4)


@pytest.mark.parametrize("arch", DECODERS)
def test_smoke_prefill_then_decode_matches_reference(arch):
    ref, got, full = run_both("smoke", arch, S=8, extra=3, max_len=32,
                              seed=1)
    for r, g in zip(ref, got):
        assert g.shape == (2, configs.get_smoke_config(arch).vocab)
        assert torch.isfinite(g).all()
        close(g, r, 1e-4)
    # the full forward only where a longer sequence routes alike: a MoE
    # smoke config's capacity (1.25) grows with S, so its drops differ
    if full is not None and not configs.get_smoke_config(arch).is_moe:
        for i, g in enumerate(got):
            close(g, full[:, i], 1e-4)


def test_swa_ring_keeps_the_last_window():
    """A prompt longer than the window writes only its last W positions."""
    cfg = ModelConfig(**CFGS["swa"])
    m = LM(cfg, device="cpu")
    cache = init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        prefill(m, {"tokens": torch.arange(15)[None]}, cache)
    W = serve.cache_width(cfg, 64)
    assert W == 6
    assert sorted(cache["pos"][0].tolist()) == list(range(15 - W, 15))
    assert all(p % W == s for s, p in enumerate(cache["pos"][0].tolist()))


def test_bf16_decode_close_to_full_forward():
    """The logits (std 0.16, largest magnitude 0.54, where a bf16 ulp is
    2**-8) equal the full forward's here, bit for bit; the limit is two
    ulps, 2**-7, for products a BLAS may block another way."""
    cfg = configs.get_smoke_config("qwen2-0.5b")
    m = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    m.to_compute(torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 14))).long()
    cache = init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        full = m(toks)
        lg, cache = prefill(m, {"tokens": toks[:, :10]}, cache)
        got = [lg]
        for i in range(10, 13):
            lg, cache = decode_step(m, toks[:, i], cache)
            got.append(lg)
    for i, g in enumerate(got):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        close(g, full[:, 9 + i], 2.0 ** -7)


@pytest.mark.parametrize("name", list(CFGS))
def test_server_greedy_tokens_equal_reference(name):
    """More requests than slots, prompts of 4-15 tokens as the launcher
    draws them: the same greedy tokens, request by request."""
    ref_cfg, cfg = config_pair("cfg", name)
    p, m = models(ref_cfg, cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 16),
                            dtype=np.int32) for _ in range(5)]
    rs = ref_serve.Server(p, ref_cfg, n_slots=2, max_len=48,
                          dtype=jnp.float32)
    ps = Server(m, n_slots=2, max_len=48, dtype=torch.float32)
    for r, pr in enumerate(prompts):
        max_new = 3 + r % 3
        rs.submit(ref_serve.Request(rid=r, prompt=pr, max_new=max_new))
        ps.submit(Request(rid=r, prompt=pr, max_new=max_new))
    want = {d.rid: d.out for d in rs.run()}
    got = {d.rid: d.out for d in ps.run()}
    assert got == want
    assert all(len(got[r]) == 3 + r % 3 + 1 for r in got)


def test_server_finishes_max_new_zero_after_prefill():
    cfg = ModelConfig(**CFGS["dense"])
    srv = Server(LM(cfg, device="cpu"), n_slots=2, max_len=32,
                 dtype=torch.float32)
    srv.submit(Request(rid=0, prompt=np.arange(5), max_new=0))
    srv.submit(Request(rid=1, prompt=np.arange(6), max_new=2))
    done = {d.rid: d.out for d in srv.run()}
    assert len(done[0]) == 1 and len(done[1]) == 3


def test_server_times_its_ticks_and_keeps_logits(monkeypatch):
    """``on_wall`` gets one prefill wall a request and one decode wall a
    tick, as obs records them; ``keep_logits`` keeps the logits every token
    of ``out`` is the argmax of, equal to a one-row prefill + decode's."""
    from repro_torch.obs import metrics
    monkeypatch.setattr(metrics, "_default", metrics.Registry(enabled=True))
    cfg = ModelConfig(**CFGS["dense"])
    m = LM(cfg, device="cpu")
    walls = []
    srv = Server(m, n_slots=2, max_len=32, dtype=torch.float32,
                 on_wall=lambda kind, s: walls.append((kind, s)),
                 keep_logits=True)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, 5 + r) for r in range(3)]
    for r, pr in enumerate(prompts):
        srv.submit(Request(rid=r, prompt=pr, max_new=4))
    ticks = 0
    while srv.step():
        ticks += 1
    kinds = [k for k, _ in walls]
    assert kinds.count("prefill") == 3 and kinds.count("decode") == ticks
    assert all(s > 0 for _, s in walls)
    snap = metrics._default.snapshot()["histograms"]
    assert snap["serve.lm_prefill_wall_s"]["count"] == 3
    assert snap["serve.lm_decode_wall_s"]["count"] == ticks
    for d in srv.done:
        assert len(d.logits) == len(d.out) == 5
        assert [int(x.argmax()) for x in d.logits] == d.out
        cache = init_cache(cfg, 1, 32, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            lg, cache = prefill(m, {"tokens": torch.as_tensor(
                d.prompt).long()[None]}, cache)
            want = [lg[0]]
            for tok in d.out[:-1]:
                lg, cache = decode_step(m, torch.tensor([tok]), cache)
                want.append(lg[0])
        for g, w in zip(d.logits, want):
            close(g, w.numpy(), 1e-5)


def test_server_casts_once_and_serves_bf16():
    cfg = configs.get_smoke_config("mamba2-780m")
    m = LM(cfg, device="cpu")
    srv = Server(m, n_slots=2, max_len=32, dtype=torch.bfloat16)
    assert srv.model.blocks[0].ssm.wz.weight.dtype == torch.bfloat16
    assert srv.model.blocks[0].ssm.A_log.dtype == torch.float32
    assert srv.cache["conv"].dtype == torch.bfloat16
    assert srv.cache["h"].dtype == torch.float32
    rng = np.random.default_rng(5)
    for r in range(3):
        srv.submit(Request(rid=r, prompt=rng.integers(0, cfg.vocab, 6),
                           max_new=4))
    done = srv.run()
    assert sorted(d.rid for d in done) == [0, 1, 2]
    assert all(len(d.out) == 5 for d in done)


def _launch(*args, timeout=600):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


@pytest.mark.slow
def test_serve_launcher_lm_smoke():
    out = _launch("--arch", "qwen2-0.5b", "--smoke", "--device", "cpu")
    assert "[serve] 8 requests, 136 tokens" in out


@pytest.mark.slow
def test_serve_launcher_graph():
    out = _launch("--graph", "--device", "cpu", "--scale", "8", "--queries",
                  "16")
    assert "[serve-graph] 16 sssp queries" in out


def test_serve_launcher_refuses_encoder_only():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hubert-xlarge", "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode != 0 and "encoder-only" in r.stderr

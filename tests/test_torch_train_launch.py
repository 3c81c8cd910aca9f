"""The port's train launcher (``python -m repro_torch.launch.train``) on the
CPU: it trains, checkpoints, resumes, and hands its checkpoint to the
serve launcher's ``--ckpt``; and it, like ``make_train_step``, refuses to
run without a card unless asked for the CPU."""
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
from repro_torch.train import OptConfig, checkpoint, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _run(module, *args, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


def test_train_resume_then_serve_the_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    train = ("repro_torch.launch.train", "--arch", "qwen2-0.5b", "--smoke",
             "--device", "cpu", "--ckpt", ck, "--microbatches", "2")
    out = _run(*train, "--steps", "6", "--ckpt-every", "3")
    assert "resumed" not in out and "[train] done" in out
    assert sorted(os.listdir(ck)) == [
        "LATEST", "ckpt_00000003.json", "ckpt_00000003.npz",
        "ckpt_00000006.json", "ckpt_00000006.npz"]
    out = _run(*train, "--steps", "8")
    assert "[train] resumed at step 6" in out and "[train] done" in out
    assert checkpoint.latest_step(ck) == 8
    out = _run("repro_torch.launch.serve", "--arch", "qwen2-0.5b", "--smoke",
               "--device", "cpu", "--ckpt", ck, "--requests", "2")
    assert "[serve] loaded checkpoint step 8" in out
    assert "[serve] 2 requests, 34 tokens" in out


def test_train_launcher_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1",
                       "--ckpt", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_train_step_refuses_a_model_on_a_missing_card(monkeypatch):
    """A model whose device is a card that is not there (a stand-in: no
    CUDA tensor can be made here) is refused when the step is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = types.SimpleNamespace(device=torch.device("cuda"),
                                  cfg=get_smoke_config("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, OptConfig())

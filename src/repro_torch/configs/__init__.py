"""Assigned-architecture registry + input-shape table.

A copy of :mod:`repro.configs` and its ten architecture files (no JAX in
them), kept here so that the port imports nothing of the JAX package.

Shapes (per the brief):
  train_4k     seq 4096,   global batch 256  (train_step)
  prefill_32k  seq 32768,  global batch 32   (serve prefill / encoder fwd)
  decode_32k   seq 32768,  global batch 128  (serve_step, 1 new token)
  long_500k    seq 524288, global batch 1    (long-context serve_step)

Skips (DESIGN.md section "Shape/skip matrix"):
  decode shapes for encoder-only hubert-xlarge;
  long_500k for pure full-attention archs (yi-34b, yi-6b, mistral-nemo-12b,
  qwen2-0.5b, pixtral-12b) - not sub-quadratic.
"""
import importlib

ARCHS = {
    "zamba2-7b": "zamba2_7b",
    "mamba2-780m": "mamba2_780m",
    "yi-34b": "yi_34b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-6b": "yi_6b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mixtral-8x7b": "mixtral_8x7b",
    "pixtral-12b": "pixtral_12b",
    "hubert-xlarge": "hubert_xlarge",
}

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def get_config(arch: str):
    mod = importlib.import_module(f".{ARCHS[arch]}", __package__)
    return mod.config()


def get_smoke_config(arch: str):
    mod = importlib.import_module(f".{ARCHS[arch]}", __package__)
    return mod.smoke_config()


def cell_status(arch: str, shape: str) -> str:
    """'run' or a documented skip reason for the (arch x shape) cell."""
    cfg = get_config(arch)
    kind = SHAPES[shape]["kind"]
    if kind == "decode" and not cfg.decoder:
        return "skip: encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic():
        return "skip: full-attention arch is not sub-quadratic at 500k"
    return "run"


def all_cells():
    for a in ARCHS:
        for s in SHAPES:
            yield a, s, cell_status(a, s)

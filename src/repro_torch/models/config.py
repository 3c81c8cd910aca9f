"""Model configuration covering all assigned architecture families.

A copy of :mod:`repro.models.config` (no JAX in it), kept here so that the
port imports nothing of the JAX package; the tests hold the two field for
field.  One dataclass describes dense/GQA, MoE, SSM (Mamba2/SSD), hybrid
(Zamba2), and stub-frontend (VLM/audio) transformers.  Exact per-arch
values live in ``repro_torch.configs.<id>``.  Of the variant fields,
``sharding_overrides`` feeds :func:`repro_torch.dist.sharding.default_rules`,
``moe_impl`` picks the MoE dispatch and ``remat_policy`` the training remat;
``moe_ep`` only chooses the reference's activation-sharding hints
(``constrain``), which the port has no counterpart of, and is carried for
parity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free)
    n_kv: int                     # kv heads (GQA)
    d_head: int
    d_ff: int
    vocab: int
    # attention options
    qkv_bias: bool = False
    swa_window: Optional[int] = None     # sliding-window attention
    rope_theta: float = 10_000.0
    causal: bool = True                  # False for encoder-only (hubert)
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_expert: bool = False      # llama4-style shared expert
    moe_capacity: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_intra_bf16: bool = False   # bf16 intra-chunk SSD matmuls (hillclimb)
    # hybrid (Zamba2): a shared attention block every `attn_every` layers
    attn_every: int = 0
    # frontend stub: None | "patch" (vlm) | "frame" (audio)
    frontend: Optional[str] = None
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # sharding variants (hillclimb levers; see EXPERIMENTS.md section Perf)
    sharding_overrides: tuple = ()    # ((logical_axis, mesh_axis|None), ...)
    moe_ep: bool = False              # expert-parallel MoE (experts->model)
    moe_impl: str = "dense_dp"        # dense_dp | ppm_ep (shard_map bins)
    remat_policy: str = "full"        # full | dots (save matmul outputs)

    def act_axis(self, logical: str):
        """Mesh axis for activation constraints of a logical dim, honoring
        sharding_overrides (None = replicate)."""
        for k, v in self.sharding_overrides:
            if k == logical:
                return v
        return "model"

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def decoder(self) -> bool:
        return self.causal

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM state, or SWA window)"""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True     # SSM backbone + a few shared-attn KV reads
        return self.swa_window is not None

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d                           # embedding (tied head)
        per_layer = 0
        if self.family in ("ssm", "hybrid"):
            di, ns, hs = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj (z,x,B,C,dt) + out_proj + conv + D + A + norm
            per_layer = d * (2 * di + 2 * ns + hs) + di * d \
                + self.ssm_conv * (di + 2 * ns) + 2 * hs + di
            n += per_layer * L
            if self.family == "hybrid" and self.attn_every:
                # one shared attention+MLP block (counted once - weights shared)
                hd = self.n_heads * self.d_head
                kvd = self.n_kv * self.d_head
                # zamba2 concatenates (hidden, residual) into the shared block
                n += 2 * d * hd + 2 * d * kvd + hd * d + 3 * d * self.d_ff
            return n
        hd = self.n_heads * self.d_head
        kvd = self.n_kv * self.d_head
        attn = d * hd + 2 * d * kvd + hd * d
        if self.is_moe:
            mlp = 3 * d * self.moe_d_ff * self.moe_experts
            if self.moe_shared_expert:
                mlp += 3 * d * self.moe_d_ff
            # router
            mlp += d * self.moe_experts
        else:
            mlp = 3 * d * self.d_ff
        n += (attn + mlp) * L
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.n_heads * self.d_head
        kvd = self.n_kv * self.d_head
        attn = d * hd + 2 * d * kvd + hd * d
        mlp = 3 * d * self.moe_d_ff * self.moe_top_k + d * self.moe_experts
        if self.moe_shared_expert:
            mlp += 3 * d * self.moe_d_ff
        return self.vocab * d + (attn + mlp) * L

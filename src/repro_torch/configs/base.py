"""Model configs and their registry.

Port of `repro.configs.base` (a module with no JAX in it, copied so that
the port imports nothing of the JAX package): `ModelConfig` with its
analytic `param_count`, the CLI aliases, `get_config` and `get_reduced`.
Each of the ten architectures of `ARCH_IDS` is a module
``repro_torch.configs.<id>`` exporting ``CONFIG`` (the published scale)
and ``reduced()`` (a CPU-sized variant of the same family), field for
field the reference's. `ShapeConfig` and `SHAPES` are the reference's
input shapes; `all_configs` maps every id to its config.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # --- hybrid (zamba2-style shared attention block) ---
    shared_attn_every: int = 0  # insert shared attn block after every k ssm layers

    # --- vlm ---
    cross_attn_every: int = 0  # a cross-attn layer every k layers
    num_patch_tokens: int = 0  # stub vision frontend token count

    # --- audio ---
    embeds_in: bool = False  # inputs are precomputed frame embeddings

    # --- common ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # params/activations dtype for production runs
    remat: bool = True
    sliding_window: int = 0  # 0 = full attention; >0 = window (used @ long ctx)
    source: str = ""  # citation for the assigned config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:  # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def torch_dtype(self) -> torch.dtype:
        """`dtype` as a torch dtype (``"bfloat16"`` -> ``torch.bfloat16``)."""
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytics -------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (matches init to within ties/norms)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d  # lm head

        def attn_params() -> int:
            p = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            if self.qkv_bias:
                p += (n_q + 2 * n_kv) * hd
            return p

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gated SwiGLU

        def ssm_params() -> int:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            g = self.ssm_groups
            conv_ch = di + 2 * g * ns
            p = d * (2 * di + 2 * g * ns + nh)  # in_proj -> z,x,B,C,dt
            p += conv_ch * self.ssm_conv_width  # depthwise conv
            p += nh * 2 + di  # A_log, D, gated-norm scale
            p += di * d  # out_proj
            return p

        per_layer = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn_params() + mlp_params(self.d_ff) + 2 * d
        elif self.family == "moe":
            per_layer = (
                attn_params()
                + self.num_experts * mlp_params(self.d_ff)
                + d * self.num_experts  # router
                + 2 * d
            )
        elif self.family == "ssm":
            per_layer = ssm_params() + d
        elif self.family == "hybrid":
            per_layer = ssm_params() + d
        total += L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            total += attn_params() + mlp_params(self.d_ff) + 2 * d  # shared once
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            total += n_cross * (attn_params() + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        dense = self.param_count() - L * self.num_experts * 3 * d * self.d_ff
        return dense + L * self.experts_per_token * 3 * d * self.d_ff


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "mamba2_2p7b",
    "qwen3_moe_30b_a3b",
    "stablelm_3b",
    "zamba2_2p7b",
    "qwen2p5_32b",
    "qwen2_1p5b",
    "yi_34b",
    "olmoe_1b_7b",
    "llama3p2_vision_11b",
    "musicgen_large",
)

# CLI-facing ids (dashes) -> module names
ARCH_ALIASES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "stablelm-3b": "stablelm_3b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2.5-32b": "qwen2p5_32b",
    "qwen2-1.5b": "qwen2_1p5b",
    "yi-34b": "yi_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama-3.2-vision-11b": "llama3p2_vision_11b",
    "musicgen-large": "musicgen_large",
}


def _arch_module(arch: str):
    mod_name = ARCH_ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: "
                         f"{', '.join(sorted(ARCH_ALIASES))}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _arch_module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _arch_module(arch).reduced()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}

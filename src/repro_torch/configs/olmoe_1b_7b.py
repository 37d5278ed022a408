"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024 vocab=50304, MoE 64e top-8.

Port of `repro.configs.olmoe_1b_7b`: the same numbers, so both packages
build the same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    rope_theta=10000.0,
    norm_eps=1e-5,
    source="arXiv:2409.02060 (OLMoE)",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        dtype="float32",
        remat=False,
    )

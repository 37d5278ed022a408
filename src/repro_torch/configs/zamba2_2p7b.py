"""zamba2-2.7b — Mamba2 + shared attention blocks [arXiv:2411.15242].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
A single *shared* transformer (attn+MLP) block is applied after every 6
Mamba2 layers (9 applications over 54 layers), following Zamba2's
parameter-sharing design.

Port of `repro.configs.zamba2_2p7b`: the same numbers, so both packages
build the same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    shared_attn_every=6,
    norm_eps=1e-5,
    source="arXiv:2411.15242 (Zamba2)",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=32,
        shared_attn_every=2,
        dtype="float32",
        remat=False,
    )

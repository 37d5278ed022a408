"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5 family].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.

Port of `repro.configs.qwen2p5_32b`: the same numbers, so both packages
build the same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    source="hf:Qwen/Qwen2.5-0.5B (family card, 32B scale)",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        dtype="float32",
        remat=False,
    )

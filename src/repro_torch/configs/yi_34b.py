"""yi-34b — llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Port of `repro.configs.yi_34b`: the same numbers, so both packages
build the same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    norm_eps=1e-5,
    source="arXiv:2403.04652 (Yi)",
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

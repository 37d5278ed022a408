"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. Port of
`repro.configs.qwen2_1p5b`: the same numbers, so both packages build the
same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
    source="arXiv:2407.10671 (Qwen2)",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2,
        d_model=192,
        num_heads=6,
        num_kv_heads=2,
        d_ff=384,
        vocab_size=512,
        dtype="float32",
        remat=False,
    )

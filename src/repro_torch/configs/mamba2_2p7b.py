"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128. Port of
`repro.configs.mamba2_2p7b`: the same numbers, so both packages build
the same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2 SSD)",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2,
        d_model=256,
        vocab_size=512,
        ssm_state=32,
        ssm_head_dim=32,
        ssm_chunk=32,
        dtype="float32",
        remat=False,
    )

"""llama-3.2-vision-11b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
The ViT/SigLIP vision encoder + projector is a STUB per the assignment:
`launch.train.make_batches` provides precomputed patch embeddings
(batch, 1600, d_model).
A cross-attention layer is inserted every 5 layers (8 cross-attn layers).

Port of `repro.configs.llama3p2_vision_11b`: the same numbers, so both packages
build the same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    num_patch_tokens=1600,
    rope_theta=500_000.0,
    norm_eps=1e-5,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        cross_attn_every=2,
        num_patch_tokens=16,
        dtype="float32",
        remat=False,
    )

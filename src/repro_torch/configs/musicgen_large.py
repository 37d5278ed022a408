"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.
The mel-spectrogram + EnCodec conv frontend is a STUB per the assignment:
`launch.train.make_batches` provides precomputed frame embeddings
(batch, seq, d_model), which the decoder backbone consumes directly; the
LM head predicts EnCodec codebook tokens (vocab 2048).

Port of `repro.configs.musicgen_large`: the same numbers, so both packages
build the same shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    embeds_in=True,
    rope_theta=10000.0,
    norm_eps=1e-5,
    source="arXiv:2306.05284 (MusicGen)",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=128,
        dtype="float32",
        remat=False,
    )

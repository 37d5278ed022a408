"""How far the port's decode drifts from its prefill in f32 on the CPU: the
basis of the bound that ``chip_smoke.py`` phase 20 (b) holds the card's
decode-against-prefill gap to.

    PYTHONPATH=src python scripts/decode_gap_reference.py [--prompt 64]

For each family of phase 20 (qwen2-1.5b, mamba2-2.7b, zamba2-2.7b,
olmoe-1b-7b, llama-3.2-vision-11b, musicgen-large), the reduced config
(f32) at 2 layers and at the full config's depth, and mamba2 also at its
full SSM width (d_model 2560, 80 heads of 64, state 128, chunk 128) at 2
and 8 layers: `decode_step` over a batch-2 prompt against `apply_model`
over it (olmoe with a capacity factor of E / k, so that no expert drops a
prompt token), printed as max |gap| over the largest |logit|. The
prefill's SSD runs through the plain intra-chunk step on the CPU. No JAX.
"""
import argparse

import torch

from repro_torch.configs.base import get_config, get_reduced
from repro_torch.models import model as M

ARCHS = ("qwen2-1.5b", "mamba2-2.7b", "zamba2-2.7b", "olmoe-1b-7b",
         "llama-3.2-vision-11b", "musicgen-large")


def gap(cfg, prompt: int, seed: int = 1) -> float:
    """max |decode - prefill| / max |prefill| over a (2, prompt) input."""
    if cfg.family == "moe":
        cfg = cfg.with_(capacity_factor=cfg.num_experts / cfg.experts_per_token)
    params = M.init_params(0, cfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    if cfg.embeds_in:
        inputs = torch.randn((2, prompt, cfg.d_model), generator=gen)
        batch = {"embeds": inputs}
    else:
        inputs = torch.randint(0, cfg.vocab_size, (2, prompt), generator=gen)
        batch = {"tokens": inputs}
    cross = None
    if cfg.family == "vlm":
        batch["cross_embeds"] = torch.randn((2, cfg.num_patch_tokens, cfg.d_model),
                                            generator=gen)
        cross = M.init_cross_kv(params, cfg, batch["cross_embeds"])
    with torch.no_grad():
        full, _ = M.apply_model(params, cfg, batch)
    state = M.init_decode_state(cfg, 2, prompt, "cpu")
    outs = []
    for t in range(prompt):
        x = inputs[:, t:t + 1] if cfg.embeds_in else inputs[:, t]
        logits, state = M.decode_step(params, cfg, x, state, cross)
        outs.append(logits)
    dec = torch.stack(outs, 1)
    return float((dec - full).abs().max() / full.abs().max())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--prompt", type=int, default=64)
    args = parser.parse_args(argv)
    torch.set_num_threads(4)
    for arch in ARCHS:
        reduced, depth = get_reduced(arch), get_config(arch).num_layers
        for layers in (2, depth):
            cfg = reduced.with_(num_layers=layers, ssm_chunk=min(reduced.ssm_chunk * 2, 64))
            print(f"{arch} reduced width, {layers} layers: {gap(cfg, args.prompt):.3e}",
                  flush=True)
    full = get_config("mamba2-2.7b")
    for layers in (2, 8):
        cfg = get_reduced("mamba2-2.7b").with_(
            num_layers=layers, d_model=full.d_model, ssm_state=full.ssm_state,
            ssm_head_dim=full.ssm_head_dim, ssm_chunk=full.ssm_chunk)
        print(f"mamba2-2.7b full SSM width, {layers} layers: {gap(cfg, args.prompt):.3e}",
              flush=True)


if __name__ == "__main__":
    main()

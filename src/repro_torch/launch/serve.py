"""Batched serving loop: prefill and decode of the DRACO-unified model.

Port of `repro.launch.serve`. Requests arrive as (prompt tokens,
max_new); the loop batches them, builds the KV/SSM caches by stepping
the decode through the prompt (the reference's cache-exact prefill),
then decodes greedily, or samples from a `torch.Generator` (Gumbel-max,
as ``jax.random.categorical`` draws). The loop keeps every token on the
device and reads nothing back until it returns them.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --batch 4 --prompt-len 32 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b   # on the card
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import as_generator, resolve_device
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.models import model as M


def serve_batch(cfg, params, prompts, max_new: int, *, cross_embeds=None,
                greedy: bool = True, generator: Optional[torch.Generator] = None):
    """prompts (B, P) int on the params' device -> (B, max_new) generated
    tokens. A vlm needs `cross_embeds` (B, P_img, d); sampling
    (``greedy=False``) draws from `generator`."""
    B, P = prompts.shape
    state = M.init_decode_state(cfg, B, P + max_new, device=prompts.device)
    cross_kv = None
    if cfg.family == "vlm":
        if cross_embeds is None:
            raise ValueError(f"{cfg.name} serves with cross_embeds (patch embeddings)")
        cross_kv = M.init_cross_kv(params, cfg, cross_embeds)
    if not greedy and generator is None:
        raise ValueError("sampling needs a generator")

    def tok_input(tok):
        # an embeds-in model (audio) is fed its token's embedding back
        return M.token_embeds(params, cfg, tok) if cfg.embeds_in else tok

    def next_token(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits.to(torch.float32) + gumbel, dim=-1)

    logits = None
    for i in range(P):  # prefill by stepping through the prompt
        logits, state = M.decode_step(params, cfg, tok_input(prompts[:, i]), state, cross_kv)
    out = []
    tok = next_token(logits)
    for _ in range(max_new):
        out.append(tok)
        logits, state = M.decode_step(params, cfg, tok_input(tok), state, cross_kv)
        tok = next_token(logits)
    return torch.stack(out, dim=1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    return ap.parse_args(argv)


def main(argv=None, cfg=None):
    """Serve one random batch with the CLI's arguments; returns the
    (B, new) tokens on the device. `cfg` replaces the ``--arch`` config
    (a depth cut of it, say)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    gen = as_generator(args.seed, dev)
    params = M.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    cross = None
    if cfg.family == "vlm":
        cross = torch.randn((args.batch, cfg.num_patch_tokens, cfg.d_model), generator=gen,
                            device=dev).to(cfg.torch_dtype)

    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, args.new_tokens, cross_embeds=cross)
    host = toks.cpu()
    dt = time.perf_counter() - t0
    total_new = args.batch * args.new_tokens
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s aggregate)")
    print("sample:", host[0, :16].tolist())
    if not bool(((host >= 0) & (host < cfg.vocab_size)).all()):
        raise AssertionError(f"tokens outside [0, {cfg.vocab_size})")
    return toks


if __name__ == "__main__":
    main()

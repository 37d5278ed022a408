"""Batched serving of a DRACO-unified model on the port (the counterpart
of `examples/serve_batched.py`).

Simulates a request queue (prompts of mixed length, left-padded into one
batch), runs prefill and greedy decode through the KV/SSM-cache serve
path (`repro_torch.launch.serve.serve_batch`) and reports each request's
tokens and the aggregate throughput. Works for the dense, ssm
(O(1)-state), moe, vlm and audio families at their reduced configs.
Runs on CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python examples/torch_serve_batched.py --arch mamba2-2.7b
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import as_generator, resolve_device
from repro_torch.configs.base import get_reduced
from repro_torch.launch.serve import serve_batch
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    gen = as_generator(0, dev)
    params = M.init_params(gen, cfg)

    # request queue: mixed prompt lengths, left-padded into one batch
    rng = np.random.default_rng(0)
    lens = rng.integers(4, args.max_prompt, size=args.requests)
    B, P = args.requests, int(lens.max())
    prompts = np.zeros((B, P), np.int64)
    for i, L in enumerate(lens):
        prompts[i, P - L:] = rng.integers(0, cfg.vocab_size, size=L)
    prompts = torch.as_tensor(prompts, device=dev)
    print(f"== serving {B} requests (prompt lens {list(lens)}) with {cfg.name} ==")

    cross = None
    if cfg.family == "vlm":
        cross = torch.randn((B, cfg.num_patch_tokens, cfg.d_model), generator=gen,
                            device=dev)

    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, args.new_tokens, cross_embeds=cross)
    host = toks.cpu().numpy()
    dt = time.perf_counter() - t0
    for i in range(B):
        print(f"req {i}: prompt_len={lens[i]:3d} -> {host[i][:8]}...")
    print(f"aggregate: {B * args.new_tokens / dt:.1f} tok/s "
          f"({dt / args.new_tokens * 1e3:.0f} ms/decode-step for batch {B})")
    assert ((host >= 0) & (host < cfg.vocab_size)).all()
    return toks


if __name__ == "__main__":
    main()

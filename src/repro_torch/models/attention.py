"""GQA attention with fully materialized scores: causal self-attention
and cross-attention.

Port of the training part of `repro.models.attention`: `init_attention`
(no QKV bias on a cross layer), `_proj_qkv` (keys and values from a
separate ``kv_x``), `_sdpa_grouped` and `full_attention` (causal, with
the optional `sliding_window` mask, or ``cross``: no RoPE and every key
visible). Shapes: activations (B, S, d); heads (B, S, H, hd). The
reference's blocked/flash path runs only at S >= 8192 and its decode
attention belongs to serving; both come with ROADMAP item 13.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg, cross: bool = False):
    """``{wq (d, Hq*hd), wk, wv (d, Hkv*hd), wo (Hq*hd, d)}`` plus zero
    ``bq, bk, bv`` when ``cfg.qkv_bias`` and not `cross`, in
    ``cfg.dtype``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dtype = cfg.torch_dtype
    p = {
        "wq": dense_init(generator, (d, nq * hd), d, dtype),
        "wk": dense_init(generator, (d, nkv * hd), d, dtype),
        "wv": dense_init(generator, (d, nkv * hd), d, dtype),
        "wo": dense_init(generator, (nq * hd, d), nq * hd, dtype),
    }
    if cfg.qkv_bias and not cross:
        dev = generator.device
        p["bq"] = torch.zeros((nq * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
    return p


def _split_heads(x, n_heads, hd):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def _proj_qkv(params, x, kv_x, cfg):
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = kv_x @ params["wk"]
    v = kv_x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (
        _split_heads(q, cfg.num_heads, hd),
        _split_heads(k, cfg.num_kv_heads, hd),
        _split_heads(v, cfg.num_kv_heads, hd),
    )


def _sdpa_grouped(q, k, v, mask, n_rep: int):
    """GQA attention without materializing the repeated K/V.

    q (B, S, Hq, hd) with Hq = Hkv * n_rep, so query head h reads KV head
    ``h // n_rep``; k/v (B, T, Hkv, hd); mask (1, 1, S, T) bool. Scores
    and softmax in f32 (masked with -1e30), probabilities cast to
    ``v.dtype`` before the value product."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, n_rep, hd)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v)
    return out.reshape(B, S, Hq, hd)


def causal_mask(S: int, T: int, sliding_window: int = 0, device=None) -> torch.Tensor:
    """(1, 1, S, T) bool: key j visible from query i iff j <= i (and
    j > i - sliding_window when the window is on)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    mask = j <= i
    if sliding_window > 0:
        mask = mask & (j > i - sliding_window)
    return mask[None, None]


def full_attention(params, x: torch.Tensor, cfg, positions=None,
                   kv_x=None, cross: bool = False,
                   sliding_window: int = 0) -> torch.Tensor:
    """Causal self-attention (RoPE at `positions`, default ``0..S-1``),
    or with `cross` attention to every row of `kv_x` without RoPE; scores
    fully materialized. x (B, S, d), kv_x (B, T, d) -> (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _proj_qkv(params, x, kv_x if kv_x is not None else x, cfg)
    T = k.shape[1]
    if cross:
        mask = torch.ones((1, 1, S, T), dtype=torch.bool, device=x.device)
    else:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        mask = causal_mask(S, T, sliding_window, device=x.device)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    out = _sdpa_grouped(q, k, v, mask, n_rep)
    return out.reshape(B, S, -1) @ params["wo"]

"""Shared layer primitives: init, RMSNorm, RoPE, SwiGLU MLP, cross-entropy.

Port of `repro.models.layers`. Every function takes and returns tensors
on the caller's device; RMSNorm and RoPE compute in f32 inside and cast
back to the input's dtype, as the reference does.

`mlp` and `token_nll` take a `repro_torch.sharding.tp.TP` for the rank's
share of a model split over "model": `mlp` on the rank's columns of
``w_gate`` and ``w_up`` and rows of ``w_down`` (on the rank's positions
under sequence parallelism), `token_nll` on the rank's block of the
vocabulary.
"""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, in_dim=None,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/in_dim) weights on the generator's device (in_dim defaults
    to ``shape[0]``)."""
    in_dim = in_dim if in_dim is not None else shape[0]
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * (1.0 / math.sqrt(max(in_dim, 1)))).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis with a ``1 + scale`` gain (zero-init
    scale is the identity gain), in f32 (f64 for an f64 input), cast back
    to ``x.dtype``."""
    wide = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(wide)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(wide))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies ``theta^(-2i/head_dim)``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split rotation. x (..., S, H, hd);
    positions (..., S) int. Computed in f32 (the angles always; the
    rotation in f64 for an f64 model, as `rms_norm` and the SSM code,
    so that f64 is an exact-arithmetic witness: a kv head's gradient
    summed over the ranks that read it is then not rounded to f32 part
    by part), cast back to ``x.dtype``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.promote_types(x.dtype, torch.float32)), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype):
    """SwiGLU weights ``{w_down (d_ff, d), w_gate (d, d_ff), w_up (d, d_ff)}``."""
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), d_model, dtype),
        "w_up": dense_init(generator, (d_model, d_ff), d_model, dtype),
        "w_down": dense_init(generator, (d_ff, d_model), d_ff, dtype),
    }


def mlp(params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU MLP. x (..., d) -> (..., d). With `tp`, the params are the
    rank's ``d_ff`` block (column-parallel gate and up, row-parallel down):
    `tp.enter` on the input, `tp.leave` on the output (`tp.copy` and
    `tp.reduce`; under sequence parallelism x is the rank's positions,
    gathered and scattered back along the sequence)."""
    if tp is not None:
        x = tp.enter(x)
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    out = h @ params["w_down"]
    return out if tp is None else tp.leave(out)


def token_nll(logits: torch.Tensor, labels: torch.Tensor, tp=None) -> torch.Tensor:
    """Per-element negative log-likelihood: logits (..., V), labels (...,),
    in f32 (f64 for f64 logits).

    With `tp`, `logits` are the rank's block of the vocabulary (ids
    ``rank * V_loc`` onwards) and the result is the whole vocabulary's,
    alike on every model rank: the max and the sum of exps are
    reduced over the ranks, and the gold logit is taken on the rank that
    holds it and summed."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logz - gold
    v_loc = logits.shape[-1]
    m = tp.max(logits.amax(dim=-1))
    logz = m + torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(dim=-1)))
    local = labels.long() - tp.rank * v_loc
    inside = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    return logz - tp.reduce(torch.where(inside, gold, 0.0))


def cross_entropy(logits, labels, mask=None, tp=None) -> torch.Tensor:
    """Mean token-level CE. logits (..., V) f32-safe; labels (...,) int;
    `tp` as in `token_nll`."""
    nll = token_nll(logits, labels, tp)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()

"""Layer primitives (port of the part of `repro.models.layers` that
`make_mlp` uses)."""
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


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element negative log-likelihood: logits (..., V), labels (...,)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def cross_entropy(logits, labels, mask=None) -> torch.Tensor:
    """Mean token-level CE. logits (..., V) f32-safe; labels (...,) int."""
    nll = token_nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()

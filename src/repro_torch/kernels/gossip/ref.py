"""Plain-torch oracles for the gossip kernels (port of `repro.kernels.gossip.ref`)."""
from __future__ import annotations

import torch


def gossip_mix_ref(q: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """out[m, :] = sum_n q[n, m] * deltas[n, :].

    q (N, N) row-stochastic (sender, receiver), deltas (N, K).
    Accumulation in f32, output in ``deltas.dtype``.
    """
    out = torch.einsum("nm,nd->md", q.to(torch.float32),
                       deltas.to(torch.float32))
    return out.to(deltas.dtype)


def gossip_enqueue_ref(w_stack: torch.Tensor, pending: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """Batched delay-bucketed mix: out[j] = w_stack[j]^T @ pending.

    w_stack (J, N, N) per-bucket masked weights (Q * M_d), pending
    (N, K). f32 accumulation; output dtype defaults to pending.dtype.
    """
    out = torch.einsum("jnm,nk->jmk", w_stack.to(torch.float32),
                       pending.to(torch.float32))
    return out.to(pending.dtype if out_dtype is None else out_dtype)


def gossip_drain_ref(w_stack: torch.Tensor, payloads: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Fused multi-window drain: out = sum_j w_stack[j]^T @ payloads[j].

    w_stack (J, N, M), payloads (J, N, K), stacked oldest-first; f32
    accumulation, output (M, K) in `out_dtype`.
    """
    out = torch.einsum("jnm,jnk->mk", w_stack.to(torch.float32),
                       payloads.to(torch.float32))
    return out.to(out_dtype)

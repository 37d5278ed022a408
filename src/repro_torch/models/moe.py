"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch.

Port of `repro.models.moe`. Tokens are ranked within their expert's queue
by a stable argsort, clipped to a per-expert capacity ``C`` (dropped
tokens pass through the residual), gathered into an ``(E, C, d)`` buffer,
run through the experts as three batched products over the stacked
expert weights, and combined with their renormalised gates.

The capacity is computed on the host from shapes only and the expert
counts on the device, so the layer reads nothing back from the device. Every index operation whose backward
accumulates is written so that its sums are deterministic on the card:
a token's k copies are an ``expand`` (backward: a sum over k), and the
dispatch and combine are gathers whose only repeated index is the zero
row of the drop bin (the reference's scatter-add ``buf.at[dst].add`` is
equal to the gather: every kept slot receives exactly one row). The
reference's ``constrain`` calls only place the expert axis on a device
mesh and are left out on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(generator: torch.Generator, cfg):
    """``{router (d, E) f32, experts_gate, experts_up (E, d, f),
    experts_down (E, f, d)}``, the experts in ``cfg.dtype``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dtype = cfg.torch_dtype
    return {
        "router": dense_init(generator, (d, E), d, torch.float32),
        "experts_gate": dense_init(generator, (E, d, f), d, dtype),
        "experts_up": dense_init(generator, (E, d, f), d, dtype),
        "experts_down": dense_init(generator, (E, f, d), f, dtype),
    }


def _capacity(T: int, cfg) -> int:
    """Per-expert queue length: ``int(cf * k * T / E)`` rounded up to a
    multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * cfg.experts_per_token * T / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_block(params, x: torch.Tensor, cfg):
    """x (B, S, d) -> (out (B, S, d), aux loss 0-d f32).

    Router logits, softmax and top-k in f32; gates renormalised over the
    k chosen (floored at 1e-9); the Switch load-balance loss
    ``E * sum(density * mean prob) * router_aux_weight``."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    dev = x.device

    logits = xt.to(torch.float32) @ params["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)  # (T, k), largest first
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = eidx.reshape(-1)  # (T*k,), token-major
    # tokens per expert as a comparison sum: `bincount` reads its input's
    # max back to the host on the card, a sync in every decode step
    counts = (flat_e[:, None] == torch.arange(E, device=dev)).sum(0)
    density = counts.to(torch.float32) / (T * k)
    aux = E * torch.sum(density * probs.mean(0)) * cfg.router_aux_weight

    # rank of each (token, slot) within its expert's queue, in token order
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    rank_sorted = torch.arange(T * k, device=dev) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    C = _capacity(T, cfg)
    keep = rank < C
    dst = torch.where(keep, flat_e * C + rank, E * C)  # E*C = the drop bin

    # dispatch: slot (e, c) reads the row routed to it, an empty slot the
    # zero row at index T*k (dropped rows are never read)
    rows = xt.unsqueeze(1).expand(T, k, d).reshape(T * k, d)
    rows = torch.cat([rows, rows.new_zeros(1, d)])
    src = torch.full((E * C + 1,), T * k, dtype=torch.long, device=dev)
    src[dst] = torch.arange(T * k, device=dev)  # repeats only in the drop bin
    buf = rows[src[:E * C]].reshape(E, C, d)

    # the experts, batched over E
    h = F.silu(torch.bmm(buf, params["experts_gate"])) * torch.bmm(buf, params["experts_up"])
    out_e = torch.bmm(h, params["experts_down"])

    # combine: each (token, slot) reads its slot's output, a dropped one
    # the zero row of the drop bin
    out_rows = torch.cat([out_e.reshape(E * C, d), out_e.new_zeros(1, d)])
    gathered = out_rows[dst] * gate.reshape(-1, 1).to(out_rows.dtype)
    out = gathered.reshape(T, k, d).sum(1)
    return out.reshape(B, S, d), aux

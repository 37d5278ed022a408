"""Local optimizers and learning-rate schedules (port of `repro.optim`).

Plain functions on tensors. Parameters, gradients and optimizer states
are nested dicts of tensors, walked in jax flatten order (sorted keys;
`repro_torch.core.flat.tree_items`). Every rule is elementwise, so the
same code updates one client's tree or a client-stacked ``(N, ...)``
tree; AdamW's bias-correction counter ``t`` is then ``(N,)``, one per
client, and broadcasts against each leaf from the left.

Schedules run on the host: ``schedule(step)`` takes the protocol's step
counter (a Python int, the window or round index) and returns a numpy
float32 scalar, computed in f32 in the reference's operation order. A
window therefore copies no host value to the card: the lr reaches each
update as a Python scalar of an f32 value.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.flat import tree_leaves, tree_map

_F32 = np.float32


class Optimizer(NamedTuple):
    init: Callable  # params -> opt_state
    update: Callable  # (grads, opt_state, params, step) -> (updates, opt_state)


def constant_schedule(lr: float):
    return lambda step: _F32(lr)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    """``lr * (final_frac + (1 - final_frac) * (1 + cos(pi t)) / 2)`` with
    ``t = clip(step / total_steps, 0, 1)``, in f32."""
    total = _F32(max(total_steps, 1))

    def fn(step):
        t = np.clip(_F32(step) / total, _F32(0.0), _F32(1.0))
        c = _F32(1.0) + np.cos(_F32(np.pi) * t)
        return _F32(lr) * (_F32(final_frac) + _F32((1 - final_frac) * 0.5) * c)

    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup over `warmup` steps, then `cosine_schedule` over the
    remaining ``total_steps - warmup``."""
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)
    span = _F32(max(warmup, 1))

    def fn(step):
        if step < warmup:
            return _F32(lr) * np.clip(_F32(step) / span, _F32(0.0), _F32(1.0))
        return cos(step - warmup)

    return fn


def _as_schedule(schedule):
    return schedule if callable(schedule) else constant_schedule(schedule)


def _per_client(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`s` (a per-client (N,) or a () tensor) shaped to broadcast over `x`."""
    return s.reshape(tuple(s.shape) + (1,) * (x.dim() - s.dim()))


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def sgd(schedule) -> Optimizer:
    schedule = _as_schedule(schedule)

    def init(params):
        return {}

    def update(grads, state, params, step):
        neg_lr = float(-schedule(step))
        return tree_map(lambda g: g.to(torch.float32) * neg_lr, grads), state

    return Optimizer(init, update)


def momentum(schedule, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    schedule = _as_schedule(schedule)

    def init(params):
        return _zeros(params)

    def update(grads, m, params, step):
        lr = schedule(step)
        m = tree_map(lambda mm, g: beta * mm + g.to(torch.float32), m, grads)
        if nesterov:
            upd = tree_map(lambda mm, g: -(float(lr) * (beta * mm + g.to(torch.float32))),
                           m, grads)
        else:
            neg_lr = float(-lr)
            upd = tree_map(lambda mm: mm * neg_lr, m)
        return upd, m

    return Optimizer(init, update)


def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW whose bias-correction counter ``t`` lives in its own state,
    not in the caller's `step`: `step` feeds the lr schedule only (the
    protocol's clock, shared by all clients), while ``t`` counts the
    updates this state has absorbed, so a client whose first gradient
    event comes late still gets the full first-step correction.

    The state is ``{"m", "t", "v"}``; raveled in sorted-key order a
    client's row is ``[m (Dflat) | t (1) | v (Dflat)]``."""
    schedule = _as_schedule(schedule)

    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.float32, device=dev)}

    def update(grads, state, params, step):
        neg_lr = float(-schedule(step))
        t = state["t"] + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def upd(mm, vv, p):
            mhat = mm / _per_client(bc1, mm)
            vhat = vv / _per_client(bc2, vv)
            return neg_lr * (mhat / (torch.sqrt(vhat) + eps)
                             + weight_decay * p.to(torch.float32))

        return tree_map(upd, m, v, params), {"m": m, "t": t, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)

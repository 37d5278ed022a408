"""Staleness-adaptive mixing weights s(delta_tau) (FedAsync families;
port of `repro.events.staleness`).

An arriving message whose payload is ``delta_tau`` superposition windows
old has its row-stochastic weight scaled by ``s(delta_tau)``:
``constant`` is the identity (DRACO's own semantics), ``hinge`` keeps a
grace period ``b`` then decays hyperbolically, ``poly`` decays
polynomially from the start. All in f32.

Two consumers: the event engine damps each message at drain time with
its exact continuous age ``(t_now - t_sent) / window`` (`staleness_fn`);
the windowed engine damps each delay bucket with its integer age through
`draco_window`'s ``damping=`` hook (`staleness_damping_vector`).
"""
from __future__ import annotations

import torch


def staleness_scale(mode: str, dtau, a: float = 0.5, b: float = 4.0) -> torch.Tensor:
    """s(delta_tau) of one family, elementwise over `dtau` (windows), f32
    on `dtau`'s device (the CPU for a list or number)."""
    dtau = torch.as_tensor(dtau, dtype=torch.float32)
    if mode == "constant":
        return torch.ones_like(dtau)
    if mode == "hinge":
        # FedAsync hinge: continuous at the grace period b and <= 1
        return 1.0 / (a * torch.clamp(dtau - b, min=0.0) + 1.0)
    if mode == "poly":
        # an f32 exponent made on dtau's device (no host copy), so the power
        # is the general f32 pow, as the reference's, for every `a`
        return (dtau + 1.0) ** torch.full((), -a, dtype=torch.float32, device=dtau.device)
    raise ValueError(f"unknown staleness mode {mode!r}")


def staleness_fn(cfg):
    """The config's damping closure ``dtau -> s(dtau)``, or None for the
    constant family (None keeps the undamped path bit for bit)."""
    mode = getattr(cfg, "staleness", "constant")
    if mode == "constant":
        return None
    a = getattr(cfg, "staleness_a", 0.5)
    b = getattr(cfg, "staleness_b", 4.0)
    return lambda dtau: staleness_scale(mode, dtau, a, b)


def staleness_damping_vector(cfg, device=None):
    """Age-indexed ``(D,)`` f32 damping vector for the windowed drain hook
    on `device` (the CPU by default).

    Entry ``j`` scales the delay bucket whose messages are ``j`` windows
    old (entry 0 is never drained: the ring walks ages 1..D-1). None for
    the constant family, keeping `draco_window` bit for bit."""
    fn = staleness_fn(cfg)
    if fn is None:
        return None
    return fn(torch.arange(cfg.max_delay_windows, dtype=torch.float32, device=device))

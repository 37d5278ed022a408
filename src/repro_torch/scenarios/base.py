"""Scenarios: time-varying graphs, node positions and rates.

Port of `repro.scenarios.base`. A generator builds a `Schedule` once, on
the host, as device rings ``(T_field, ...)``; a step reads its snapshot
with ``schedule.at(t)``, which indexes every ring with the host int ``t
% T_field`` and so returns views: no device work, no host sync. Each
field rings at its own period, so a straggler profile over a frozen
graph stores one ``(1, N, N)`` Q beside a ``(T, N)`` rate ring.

Invariants at every scheduled step (`validate_schedule`): a
row-stochastic zero-diagonal ``q_t`` supported on the boolean
zero-diagonal ``adj_t``, a symmetric doubly stochastic ``w_sym_t``, and
non-negative rate rings.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch


class Snapshot(NamedTuple):
    """One step's world, as the step functions take it. `positions`,
    `compute_rate` and `tx_rate` are None where the scenario does not vary
    them (the step then keeps its frozen-path behaviour)."""

    q: torch.Tensor  # (N, N) row-stochastic gossip weights
    adj: torch.Tensor  # (N, N) bool adjacency
    w_sym: torch.Tensor  # (N, N) symmetric Metropolis weights
    positions: Optional[torch.Tensor] = None  # (N, 2) node coordinates
    compute_rate: Optional[torch.Tensor] = None  # (N,) lambda_grad multiplier
    tx_rate: Optional[torch.Tensor] = None  # (N,) lambda_tx multiplier


class Schedule(NamedTuple):
    """Precomputed scenario rings on one device; leading axes are the
    per-field periods."""

    q: torch.Tensor  # (Tq, N, N) f32
    adj: torch.Tensor  # (Tq, N, N) bool
    w_sym: torch.Tensor  # (Tq, N, N) f32
    positions: Optional[torch.Tensor] = None  # (Tp, N, 2) f32
    compute_rate: Optional[torch.Tensor] = None  # (Tr, N) f32
    tx_rate: Optional[torch.Tensor] = None  # (Tt, N) f32

    @property
    def period(self) -> int:
        """Longest field period."""
        return max(x.shape[0] for x in self if x is not None)

    @property
    def num_clients(self) -> int:
        return self.q.shape[1]

    def at(self, t: int) -> Snapshot:
        """Step-`t` snapshot: each ring's row ``t % period``, a view."""
        def pick(x):
            return None if x is None else x[t % x.shape[0]]

        return Snapshot(*(pick(x) for x in self))


GeneratorFn = Callable[..., Schedule]

_REGISTRY: Dict[str, GeneratorFn] = {}


def register_scenario(name: str):
    """Decorator: register ``fn(cfg, key=None, *, device=None, **knobs) ->
    Schedule``."""

    def deco(fn: GeneratorFn) -> GeneratorFn:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_scenario(name: str) -> GeneratorFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(_REGISTRY)}") from None


def list_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_schedule(scenario: Union[str, Schedule], cfg, key=None, *, device=None,
                  **knobs) -> Schedule:
    """Build (or pass through) a `Schedule` for a config. `key` (an int
    seed or a `torch.Generator`) seeds the random structure; ``device=None``
    means CUDA."""
    if isinstance(scenario, Schedule):
        if knobs:
            raise ValueError("knobs are only valid with a generator name")
        return scenario
    return get_scenario(scenario)(cfg, key=key, device=device, **knobs)


def check_snapshot(q, adj, w_sym, atol: float = 1e-5, label: str = "") -> None:
    """Raise unless one step holds the invariants: row-stochastic
    zero-diagonal Q supported on the zero-diagonal adjacency, symmetric
    doubly stochastic non-negative Metropolis weights."""
    from repro_torch.core.topology import is_row_stochastic

    q, adj = q.detach().cpu(), adj.detach().cpu()
    checks = (
        (is_row_stochastic(q), "q not row-stochastic"),
        (float(torch.diagonal(q).abs().max()) == 0.0, "q diagonal"),
        (not bool(torch.diagonal(adj).any()), "adj diagonal"),
        (bool(((q > 0) <= adj).all()), "q off adj support"),
    )
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{what} {label}")
    w = w_sym.detach().cpu().numpy()
    np.testing.assert_allclose(w, w.T, atol=atol, err_msg=f"w_sym asymmetric {label}")
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=atol, err_msg=f"w_sym rows {label}")
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=atol, err_msg=f"w_sym cols {label}")
    if not (w >= -atol).all():
        raise AssertionError(f"negative w_sym {label}")


def validate_schedule(sched: Schedule, atol: float = 1e-5) -> None:
    """Raise unless every scheduled step holds the invariants (host
    check: generators and tests, not the loop)."""
    tq, n, _ = sched.q.shape
    if sched.adj.shape != (tq, n, n) or sched.w_sym.shape != (tq, n, n):
        raise AssertionError("q, adj and w_sym rings differ in shape")
    if sched.adj.dtype != torch.bool:
        raise AssertionError(f"adj ring is {sched.adj.dtype}, not bool")
    for t in range(tq):
        check_snapshot(sched.q[t], sched.adj[t], sched.w_sym[t], atol=atol,
                       label=f"at step {t}")
    if sched.positions is not None and tuple(sched.positions.shape[1:]) != (n, 2):
        raise AssertionError(f"positions ring {tuple(sched.positions.shape)}")
    for rates in (sched.compute_rate, sched.tx_rate):
        if rates is not None:
            if tuple(rates.shape[1:]) != (n,):
                raise AssertionError(f"rate ring {tuple(rates.shape)}")
            if not bool((rates >= 0).all()):
                raise AssertionError("negative rate ring")

"""DRACO and the paper's four Sec. 5 baselines as registered `Algorithm`s
(port of `repro.api.algorithms`).

Each is a thin adapter over the step functions of
`repro_torch.core.protocol` and `repro_torch.core.baselines`, handing
them the step-t world (`_view`): the scenario schedule's snapshot when
the context carries one, else the frozen graph. Push-sum de-biasing
lives in `eval_params`, not in the step, as in the paper's evaluation.
The event family registers in `repro_torch.events.algorithms`.

Each declares the config fields a sweep may re-bind per grid row
(`sweepable`), and whether it runs a sweep's seeds as one seed-stacked
state (`seed_axis`: `draco`'s window takes the R seeds in one pass) or
one solo state after another.
"""
from __future__ import annotations

import math

from repro_torch.api.algorithm import register_algorithm
from repro_torch.core import baselines as baselines_lib
from repro_torch.core import protocol as protocol_lib
from repro_torch.scenarios.base import Snapshot

# Partial-participation probability of the async baselines (the fig3
# compute matching assumes this value; the reference's default).
P_ACTIVE = 0.5


def _view(ctx, t: int) -> Snapshot:
    """The step-`t` world: the schedule's ring rows (views, no device
    work) when the context carries one, else the frozen graph with no
    positions or rates (the steps' frozen path)."""
    if ctx.schedule is None:
        return Snapshot(ctx.q, ctx.adj, ctx.w_sym)
    return ctx.schedule.at(t)


@register_algorithm("draco")
class Draco:
    """Paper Algorithm 1/2: decoupled Poisson grad/tx events, row-
    stochastic gossip with Psi cap, delay ring buffer, unification."""

    # config fields a sweep may re-bind per grid row
    sweepable = ("lr", "lambda_grad", "lambda_tx", "psi")
    seed_axis = True
    # a client mesh (`repro_torch.launch.mesh.Mesh`) the windows run on, set
    # by `simulate_sweep(mesh=)`'s adapter; None on one device
    mesh = None

    def init(self, key, cfg, params0, task=None, *, device=None):
        return protocol_lib.init_state(key, cfg, params0, task=task,
                                       device=device)

    def step(self, state, ctx, draws=None):
        v = _view(ctx, state.window_idx)
        return protocol_lib.draco_window(
            state, ctx.cfg, v.q, v.adj, ctx.task, ctx.data,
            spec=ctx.flat_spec if self.mesh is None else None, draws=draws,
            positions=v.positions, compute_rate=v.compute_rate, tx_rate=v.tx_rate,
            overrides=ctx.overrides, mesh=self.mesh)

    def step_index(self, state) -> int:
        return state.window_idx

    def eval_params(self, state):
        return state.params

    def grads_per_step(self, cfg):
        # P(>= 1 Poisson grad event in one superposition window)
        return 1.0 - math.exp(-cfg.lambda_grad * cfg.window)


def _scenario(v: Snapshot, ctx):
    """The snapshot fields a baseline round takes (it has no tx rate),
    and the sweep row's lr."""
    return dict(positions=v.positions, compute_rate=v.compute_rate, lr=_Baseline._lr(ctx))


class _Baseline:
    """Shared init, evaluation and pricing of the four baselines."""

    # the baselines read cfg.lr only (through the local step); the
    # Poisson-rate and Psi knobs are DRACO's
    sweepable = ("lr",)
    seed_axis = False

    def init(self, key, cfg, params0, task=None, *, device=None):
        return baselines_lib.init_baseline_state(key, cfg, params0, task=task,
                                                 device=device)

    def step_index(self, state) -> int:
        return state.round_idx

    @staticmethod
    def _lr(ctx):
        return None if ctx.overrides is None else ctx.overrides.lr

    def eval_params(self, state):
        return baselines_lib.eval_params(self.name, state)

    def grads_per_step(self, cfg):
        return 1.0


@register_algorithm("sync-symm")
class SyncSymm(_Baseline):
    """Synchronous D-SGD with symmetric Metropolis mixing."""

    def step(self, state, ctx, draws=None):
        v = _view(ctx, state.round_idx)
        return baselines_lib.sync_symm_round(state, ctx.cfg, v.w_sym, v.adj, ctx.task,
                                             ctx.data, draws=draws, **_scenario(v, ctx))


@register_algorithm("sync-push")
class SyncPush(_Baseline):
    """Synchronous push-sum over the directed graph (gradient push)."""

    def step(self, state, ctx, draws=None):
        v = _view(ctx, state.round_idx)
        return baselines_lib.sync_push_round(state, ctx.cfg, v.adj, ctx.task, ctx.data,
                                             draws=draws, **_scenario(v, ctx))[0]


@register_algorithm("async-symm")
class AsyncSymm(_Baseline):
    """Async partial participation + symmetric mixing among survivors."""

    def step(self, state, ctx, draws=None):
        v = _view(ctx, state.round_idx)
        return baselines_lib.async_symm_round(state, ctx.cfg, v.w_sym, v.adj, ctx.task,
                                              ctx.data, P_ACTIVE, draws=draws,
                                              **_scenario(v, ctx))

    def grads_per_step(self, cfg):
        return P_ACTIVE


@register_algorithm("async-push")
class AsyncPush(_Baseline):
    """Async push-sum gossip (Digest-style half-mass pushes)."""

    def step(self, state, ctx, draws=None):
        v = _view(ctx, state.round_idx)
        return baselines_lib.async_push_round(state, ctx.cfg, v.adj, ctx.task, ctx.data,
                                              P_ACTIVE, draws=draws, **_scenario(v, ctx))[0]

    def grads_per_step(self, cfg):
        return P_ACTIVE

"""DRACO as a registered `Algorithm` (port of `repro.api.algorithms`;
the four baselines wait for ROADMAP.md queue 1 item 7)."""
from __future__ import annotations

import math

from repro_torch.api.algorithm import register_algorithm
from repro_torch.core import protocol as protocol_lib


@register_algorithm("draco")
class Draco:
    """Paper Algorithm 1/2: decoupled Poisson grad/tx events, row-
    stochastic gossip with Psi cap, delay ring buffer, unification."""

    def init(self, key, cfg, params0, task=None, *, device=None):
        return protocol_lib.init_state(key, cfg, params0, task=task,
                                       device=device)

    def step(self, state, ctx, draws=None):
        return protocol_lib.draco_window(
            state, ctx.cfg, ctx.q, ctx.adj, ctx.task, ctx.data,
            spec=ctx.flat_spec, draws=draws)

    def eval_params(self, state):
        return state.params

    def grads_per_step(self, cfg):
        # P(>= 1 Poisson grad event in one superposition window)
        return 1.0 - math.exp(-cfg.lambda_grad * cfg.window)

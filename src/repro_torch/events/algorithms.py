"""The event algorithm family as registered `Algorithm`s (port of
`repro.events.algorithms`).

Three continuous-timeline methods over the same `event_step`:

  draco-event       exact-timeline DRACO (Algorithm 2 with no window
                    discretization);
  fedasync-gossip   DRACO with FedAsync staleness damping: arriving
                    weights scaled by s(delta_tau) at the exact
                    continuous message age (`cfg.staleness*`);
  event-triggered   DRACO with broadcast suppression: a transmission
                    fires only when the pending backlog's L2 norm
                    reaches `cfg.trigger_threshold` (`tx_sent` counts
                    the broadcasts that went out);

and one windowed hybrid, `fedasync-window`: windowed DRACO with the
staleness vector applied per delay bucket through `draco_window`'s
``damping=`` hook (with ``staleness="constant"`` it is `draco` bit for
bit), which keeps `draco`'s seed axis.

The tape-walking three sweep over `lr` and `psi` only: the Poisson rates
shape the sampled tape itself, so sweeping them in one call is
rejected (resample tapes instead). They run a sweep's seeds one solo
state after another. On a client mesh (`repro_torch.api.algorithms.on_mesh`)
each runs on the rank's clients, as `draco` does: `event_step`'s `mesh`
and `draco_window`'s.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.api.algorithm import register_algorithm
from repro_torch.api.algorithms import Draco, _view, gathered
from repro_torch.core import protocol as protocol_lib
from repro_torch.events import engine
from repro_torch.events.staleness import staleness_damping_vector, staleness_fn


class _EventAlgo:
    """Shared scaffolding of the tape-walking family."""

    # lambda_grad / lambda_tx are baked into the sampled tape; only the
    # per-event knobs can be re-bound per grid row
    sweepable = ("lr", "psi")
    seed_axis = False
    use_damping = False
    use_trigger = False
    mesh = None  # the client mesh the events run on (`on_mesh`)

    def init(self, key, cfg, params0, task=None, *, device=None):
        return engine.init_event_state(key, cfg, params0, task=task, device=device)

    def step(self, state, ctx, draws=None):
        cfg = ctx.cfg
        damping = staleness_fn(cfg) if self.use_damping else None
        trigger = float(getattr(cfg, "trigger_threshold", 0.0)) if self.use_trigger else 0.0
        return engine.event_step(state, ctx, damping=damping, trigger=trigger, draws=draws,
                                 mesh=self.mesh)

    def step_index(self, state) -> int:
        return state.event_idx

    def eval_params(self, state):
        return gathered(self.mesh, state.params)

    def grads_per_step(self, cfg):
        # one tape row is one merged-process event; a share lambda_grad /
        # (lambda_grad + lambda_tx) of them are gradient events, each of a
        # single client (the windowed engine thins per client)
        lam_g = float(np.sum(cfg.lambda_grad))
        lam = lam_g + float(np.sum(cfg.lambda_tx))
        if lam <= 0:
            return 0.0
        return lam_g / (cfg.num_clients * lam)


@register_algorithm("draco-event")
class DracoEvent(_EventAlgo):
    """Exact-timeline DRACO: the merged Poisson tape, no windows."""


@register_algorithm("fedasync-gossip")
class FedAsyncGossip(_EventAlgo):
    """Staleness-weighted event gossip: drain weights scaled by
    s(delta_tau) at the exact continuous message age."""

    use_damping = True


@register_algorithm("event-triggered")
class EventTriggered(_EventAlgo):
    """Threshold-triggered broadcasting: transmissions below the backlog
    threshold are suppressed (the backlog keeps accumulating)."""

    use_trigger = True


@functools.lru_cache(maxsize=None)
def _damping(cfg, device):
    """The config's (D,) damping vector on `device`, built once."""
    return staleness_damping_vector(cfg, device=device)


@register_algorithm("fedasync-window")
class FedAsyncWindow(Draco):
    """Windowed DRACO + per-bucket staleness damping (the `damping=`
    hook of `draco_window`); discrete counterpart of fedasync-gossip."""

    def step(self, state, ctx, draws=None):
        v = _view(ctx, state.window_idx)
        return protocol_lib.draco_window(
            state, ctx.cfg, v.q, v.adj, ctx.task, ctx.data,
            spec=ctx.flat_spec if self.mesh is None else None, draws=draws,
            positions=v.positions, compute_rate=v.compute_rate, tx_rate=v.tx_rate,
            overrides=ctx.overrides, damping=_damping(ctx.cfg, ctx.q.device),
            mesh=self.mesh)

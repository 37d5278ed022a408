"""`SimContext`: the immutable per-run simulation context.

Port of `repro.api.context` with the fields the port uses: the config,
the task (or a bare batched loss), the row-stochastic Q, its adjacency
and its Metropolis weights (the symmetric baselines' mix), the federated
shards, the flat-plane layout (with the optimizer plane's width), and an
optional scenario `Schedule` whose step-t snapshot the steps read, all
built once per run on the run's device. Two slots are set by the engines
that drive a context: `overrides` (a `repro_torch.core.protocol.Overrides`
of one sweep row, set by `repro_torch.api.sweep`) and `tape` (the
`repro_torch.events.EventTape` the continuous-time event engine walks,
set by `repro_torch.events.events_context`); both are None otherwise.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import flat as flat_lib
from repro_torch.core.flat import FlatSpec
from repro_torch.core.protocol import build_graph
from repro_torch.core.topology import metropolis


class SimContext(NamedTuple):
    cfg: Any
    task: Any  # a `Task` or a bare batched loss callable
    q: torch.Tensor  # (N, N) f32 row-stochastic
    adj: torch.Tensor  # (N, N) bool
    data: Any  # (xs (N, S, ...), ys (N, S, ...))
    flat_spec: Optional[FlatSpec] = None
    w_sym: Optional[torch.Tensor] = None  # (N, N) f32 Metropolis weights of adj
    schedule: Any = None  # a `repro_torch.scenarios.Schedule`, or None
    overrides: Any = None  # a sweep row's `Overrides`, or None
    tape: Any = None  # an `EventTape` (host numpy), or None


def make_context(cfg, loss_fn=None, data=None, *, task=None, params0=None,
                 graph_seed: Optional[int] = None, scenario=None,
                 scenario_key=None, scenario_kwargs=None, device=None) -> SimContext:
    """Build a `SimContext` from a `DracoConfig` on `device` (None means
    CUDA). `params0` fixes the flat layout once per run (and, for a task,
    the width of its optimizer plane); `graph_seed` seeds random
    topologies. Pass the workload as `task=` (a `Task` or a registry
    name) or a bare batched loss in the `loss_fn` position.

    `scenario` (a `repro_torch.scenarios` generator name or a built
    `Schedule`) attaches time-varying rings: ``q``, ``adj`` and ``w_sym``
    become its step-0 snapshot and the steps read ``schedule.at(t)``.
    `scenario_key` seeds the generator (default `graph_seed`, so
    ``"static"`` gives the frozen graph bit for bit); `scenario_kwargs`
    are its knobs."""
    from repro_torch.tasks import get_task, is_task
    from repro_torch.tasks.base import opt_width

    if task is not None and loss_fn is not None and task is not loss_fn:
        raise ValueError("pass the workload as either task= or the loss_fn "
                         "position, not both")
    task = task if task is not None else loss_fn
    if isinstance(task, str):
        task = get_task(task)
    schedule = None
    if scenario is None:
        if scenario_key is not None or scenario_kwargs:
            # a forgotten scenario= would run the frozen graph silently
            raise ValueError("scenario_key/scenario_kwargs given without scenario=")
        q, adj = build_graph(cfg, seed=graph_seed, device=device)
        w_sym = metropolis(adj)
    else:
        from repro_torch.scenarios import make_schedule

        key = scenario_key if scenario_key is not None else graph_seed
        schedule = make_schedule(scenario, cfg, key=key, device=device,
                                 **(scenario_kwargs or {}))
        if schedule.num_clients != cfg.num_clients:
            raise ValueError(f"schedule is for {schedule.num_clients} clients, "
                             f"cfg.num_clients={cfg.num_clients}")
        q, adj, w_sym = schedule.q[0], schedule.adj[0], schedule.w_sym[0]
    flat_spec = None
    if params0 is not None:
        flat_spec = flat_lib.spec_for(params0, cfg.num_clients)
        if is_task(task):
            flat_spec = flat_spec.with_opt(opt_width(task, params0))
    return SimContext(cfg, task, q, adj, data, flat_spec, w_sym, schedule)

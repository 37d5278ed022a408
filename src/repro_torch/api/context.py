"""`SimContext`: the immutable per-run simulation context.

Port of `repro.api.context` with the fields the port uses: the config,
the task (or a bare batched loss), the row-stochastic Q, its adjacency
and its Metropolis weights (the symmetric baselines' mix), the federated
shards and the flat-plane layout, all built once per run on the run's
device. Scenario schedules, sweep overrides and event tapes wait for
later slices (ROADMAP.md queue 1 items 9-11).
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
    data: Any  # (xs (N, S, ...), ys (N, S))
    flat_spec: Optional[FlatSpec] = None
    w_sym: Optional[torch.Tensor] = None  # (N, N) f32 Metropolis weights of adj


def make_context(cfg, loss_fn=None, data=None, *, task=None, params0=None,
                 graph_seed: Optional[int] = None, device=None) -> SimContext:
    """Build a `SimContext` from a `DracoConfig` on `device` (None means
    CUDA). `params0` fixes the flat layout once per run; `graph_seed`
    seeds random topologies. Pass the workload as `task=` (a `Task` or a
    registry name) or a bare batched loss in the `loss_fn` position."""
    from repro_torch.tasks import get_task

    if task is not None and loss_fn is not None and task is not loss_fn:
        raise ValueError("pass the workload as either task= or the loss_fn "
                         "position, not both")
    task = task if task is not None else loss_fn
    if isinstance(task, str):
        task = get_task(task)
    q, adj = build_graph(cfg, seed=graph_seed, device=device)
    flat_spec = None
    if params0 is not None:
        flat_spec = flat_lib.spec_for(params0, cfg.num_clients)
    return SimContext(cfg, task, q, adj, data, flat_spec, metropolis(adj))

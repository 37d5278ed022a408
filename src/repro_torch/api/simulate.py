"""Simulation driver for any registered `Algorithm` (port of
`repro.api.simulate`).

`simulate` runs the protocol steps in one Python loop on the run's
device, sampling the metric dict (mean client metric on a held-out set,
consensus distance) every `eval_every` steps as device scalars. Nothing
in the loop reads the device; the trace comes to the host once, at the
end.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import as_generator, resolve_device
from repro_torch.api.algorithm import Algorithm, get_algorithm
from repro_torch.api.context import SimContext, make_context
from repro_torch.core import flat as flat_lib
from repro_torch.core.protocol import seed_row


class SimTrace(NamedTuple):
    """Sampled metrics. `step[k]` is the 1-indexed step after which
    `metrics[...][k]` was measured: ``num_steps // eval_every`` rows, plus
    one final row at `num_steps` when ``num_steps % eval_every != 0``,
    so the trace always reflects the end-of-run model. Empty arrays when
    ``eval_every == 0``; `step` is int32."""

    step: np.ndarray
    metrics: Dict[str, np.ndarray]


def consensus_distance(params) -> torch.Tensor:
    """RMS distance of per-client params to the virtual global model,
    sqrt(mean_i ||x_i - x_bar||^2), on the flat plane."""
    x = flat_lib.ravel_clients(params)
    xbar = x.mean(dim=0, keepdim=True)
    return torch.sqrt(((x - xbar) ** 2).sum() / x.shape[0])


def _metrics(algo, state, eval_fn, eval_data, metric_name="accuracy"):
    p = algo.eval_params(state)
    out = {"consensus": consensus_distance(p)}
    if eval_fn is not None:
        ex, ey = eval_data
        out[metric_name] = eval_fn(p, ex, ey).mean().to(torch.float32)
    return out


def _run(algo, ctx, state, eval_data, num_steps: int, eval_every: int,
         eval_fn, metric_name: str, draws_fn, seeds: int = 0):
    """`num_steps` protocol steps with metric rows at every multiple of
    `eval_every` and a final row at `num_steps` if it is not one.

    ``seeds > 0`` runs a seed-stacked state of that many seeds (an
    algorithm with a `seed_axis`): each metric is measured on each seed's
    row (`protocol.seed_row`) as a solo run measures it, and the trace's
    metrics are ``(seeds, num_evals)``."""
    def measure(st):
        if not seeds:
            return _metrics(algo, st, eval_fn, eval_data, metric_name)
        per_seed = [_metrics(algo, seed_row(st, r), eval_fn, eval_data, metric_name)
                    for r in range(seeds)]
        return {k: torch.stack([m[k] for m in per_seed]) for k in per_seed[0]}

    steps, rows = [], []
    with torch.no_grad():
        for s in range(num_steps):
            draws = None if draws_fn is None else draws_fn(algo.step_index(state))
            state = algo.step(state, ctx, draws)
            if eval_every > 0 and (s + 1) % eval_every == 0:
                steps.append(s + 1)
                rows.append(measure(state))
        if eval_every > 0 and num_steps % eval_every:
            steps.append(num_steps)
            rows.append(measure(state))
    if not rows:
        return state, SimTrace(np.zeros((0,), np.int32), {})
    metrics = {k: np.moveaxis(torch.stack([r[k] for r in rows]).cpu().numpy(), 0, -1)
               for k in rows[0]}
    return state, SimTrace(np.asarray(steps, np.int32), metrics)


def simulate(
    algo: Union[str, Algorithm],
    cfg,
    params0=None,
    loss_fn: Optional[Callable] = None,
    data: Any = None,
    num_steps: int = 1,
    *,
    task=None,
    task_key=None,
    key=None,
    eval_every: int = 0,
    eval_fn: Optional[Callable] = None,
    eval_data: Any = None,
    ctx: Optional[SimContext] = None,
    state: Any = None,
    graph_seed: Optional[int] = None,
    scenario=None,
    scenario_key=None,
    scenario_kwargs=None,
    device=None,
    draws_fn: Optional[Callable] = None,
):
    """Run `num_steps` of a registered algorithm; returns
    ``(final_state, SimTrace)``.

    The reference's arguments, with the port's spellings: `key` and
    `task_key` are int seeds or `torch.Generator`s (`task_key` defaults
    to 0, so repeated calls see the same workload); `loss_fn` and
    `eval_fn` are batched over clients (see `repro_torch.tasks.base`);
    `graph_seed` seeds random topologies. `scenario` (a
    `repro_torch.scenarios` generator name or a built `Schedule`), with
    its `scenario_key` and `scenario_kwargs`, gives every step the
    schedule's graph, positions and rates (see `make_context`); a
    prebuilt `ctx` brings its own. ``device=None`` means CUDA and
    raises without it. `draws_fn(i)`, for tests, injects the draws of the
    algorithm's step `i` (`algo.step_index`: the window index of `draco`,
    the round index of a baseline): a `WindowDraws` or a `RoundDraws`.
    """
    from repro_torch.tasks import is_task

    dev = resolve_device(device)
    if isinstance(algo, str):
        algo = get_algorithm(algo)
    task, workload, params0, data, eval_data = resolve_workload(
        cfg, task, task_key, loss_fn, params0, data, eval_data,
        need_params=state is None or ctx is None, need_data=ctx is None,
        device=dev)
    if ctx is None:
        data = tuple(t.to(dev) for t in data)
        ctx = make_context(cfg, workload, data, params0=params0,
                           graph_seed=graph_seed, scenario=scenario,
                           scenario_key=scenario_key,
                           scenario_kwargs=scenario_kwargs, device=dev)
    elif scenario is not None:
        raise ValueError("pass scenario to make_context when prebuilding ctx; "
                         "a ctx already carries its schedule")
    elif ctx.cfg != cfg:
        raise ValueError("ctx.cfg differs from cfg; pass ctx._replace(cfg=cfg) "
                         "to reuse a context across config variants")
    elif workload is not None and ctx.task != workload:
        raise ValueError("ctx.task differs from the task/loss_fn argument; "
                         "pass ctx._replace(task=...) to rebind the workload")
    metric_name = "accuracy"
    if eval_fn is None and is_task(ctx.task) and eval_data is not None:
        eval_fn = ctx.task.eval_fn
    if is_task(ctx.task) and eval_fn is ctx.task.eval_fn:
        metric_name = ctx.task.metric_name
    if state is None:
        if key is None:
            raise ValueError("key is required when no state is given")
        state = algo.init(key, cfg, params0, task=ctx.task, device=dev)
    if eval_fn is not None and eval_data is None:
        raise ValueError("eval_fn requires eval_data=(ex, ey)")
    if eval_data is not None:
        eval_data = tuple(t.to(dev) for t in eval_data)
    return _run(algo, ctx, state, eval_data, int(num_steps), int(eval_every),
                eval_fn, metric_name, draws_fn)


def resolve_workload(cfg, task, task_key, loss_fn, params0, data, eval_data,
                     *, need_params: bool, need_data: bool, device=None):
    """Resolve registry names, reject conflicting spellings, and build only
    the missing pieces from the task's builders (params first, then data,
    from one generator seeded by `task_key`). Returns ``(task, workload,
    params0, data, eval_data)``; `workload` is the task or the bare loss."""
    from repro_torch.tasks import get_task, is_task

    if isinstance(task, str):
        task = get_task(task)
    if task is None and is_task(loss_fn):
        task = loss_fn
    if task is not None:
        if loss_fn is not None and loss_fn is not task:
            raise ValueError("pass the workload as either task= or "
                             "loss_fn=, not both")
        need_params = need_params and params0 is None
        need_data = need_data and data is None
        if need_params or need_data:
            g = as_generator(task_key, device)
            if need_params:
                params0 = task.init_params(g)
            if need_data:
                data, ev = task.make_data(g, cfg.num_clients)
                if eval_data is None:
                    eval_data = ev
    elif task_key is not None:
        raise ValueError("task_key given without task=")
    workload = task if task is not None else loss_fn
    return task, workload, params0, data, eval_data


def steps_for_budget(algo: Union[str, Algorithm], cfg, budget_grads: float,
                     task=None) -> int:
    """Steps matching a per-client compute budget: ``budget /
    (grads_per_step(cfg) * grad_cost)``, with ``grad_cost`` 1 without a
    task (event counts) and the task's MFLOPs per event with one."""
    if isinstance(algo, str):
        algo = get_algorithm(algo)
    cost = 1.0
    if task is not None:
        from repro_torch.tasks import get_task

        cost = (get_task(task) if isinstance(task, str) else task).grad_cost
    rate = algo.grads_per_step(cfg) * cost
    return max(1, int(round(budget_grads / max(rate, 1e-12))))

"""`simulate_events`: the continuous-timeline driver (port of
`repro.events.driver`).

A thin front end over `repro_torch.api.simulate`: the tape is sampled
on the host (`repro_torch.events.tape`), attached to the `SimContext`
(its `tape` slot), and the run is `simulate(...)` with ``num_steps ==
tape.capacity``: the same loop, metric cadence and `simulate_sweep`
axes, with `event_step` as the step (the algorithm's step index is the
tape cursor). api imports are deferred into the functions, so that
`repro_torch.events` imports without `repro_torch.api` first.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.events.tape import EventTape, sample_event_tape


def events_context(cfg, loss_fn=None, data: Any = None, *, task=None,
                   params0: Any = None, horizon: Optional[float] = None,
                   capacity: Optional[int] = None, tape: Optional[EventTape] = None,
                   tape_seed=0, graph_seed=None, scenario=None, scenario_key=None,
                   scenario_kwargs=None, device=None):
    """`make_context` + a sampled `EventTape` on the `tape` slot.

    `horizon` is the run length in seconds (the tape covers [0,
    horizon)), or pass a prebuilt `tape=`. `capacity` pads the tape to a
    fixed length (`tape_capacity` when omitted). Under a scenario
    schedule the sampling follows its rate rings (Poisson thinning).
    ``device=None`` means CUDA."""
    from repro_torch.api.context import make_context

    ctx = make_context(cfg, loss_fn, data, task=task, params0=params0,
                       graph_seed=graph_seed, scenario=scenario,
                       scenario_key=scenario_key, scenario_kwargs=scenario_kwargs,
                       device=device)
    if tape is None:
        if horizon is None:
            raise ValueError("pass horizon= (seconds) or a prebuilt tape=")
        tape = sample_event_tape(cfg, horizon, seed=tape_seed, schedule=ctx.schedule,
                                 capacity=capacity)
    return ctx._replace(tape=tape)


def simulate_events(
    algo,
    cfg,
    params0=None,
    loss_fn: Optional[Callable] = None,
    data: Any = None,
    *,
    horizon: Optional[float] = None,
    capacity: Optional[int] = None,
    tape: Optional[EventTape] = None,
    tape_seed=0,
    task=None,
    task_key=None,
    key=None,
    eval_every: int = 0,
    eval_fn: Optional[Callable] = None,
    eval_data: Any = None,
    ctx=None,
    state: Any = None,
    graph_seed=None,
    scenario=None,
    scenario_key=None,
    scenario_kwargs=None,
    device=None,
    draws_fn: Optional[Callable] = None,
):
    """Run an event algorithm over one sampled timeline; returns
    ``(final EventState, SimTrace)``.

    The arguments of `repro_torch.api.simulate`, with the step axis
    replaced by the timeline: `horizon` (seconds) + `tape_seed` sample
    the merged Poisson tape on the host, or pass `tape=` or a ctx from
    `events_context`. `eval_every` counts tape rows, so the trace's
    `step` is an event index. `draws_fn(e)`, for tests, injects row e's
    `EventDraws`. ``device=None`` means CUDA."""
    from repro_torch import resolve_device
    from repro_torch.api.simulate import resolve_workload, simulate
    from repro_torch.tasks import is_task

    dev = resolve_device(device)
    if ctx is not None and task is None and loss_fn is None:
        # a prebuilt ctx knows its workload: adopt it, so that params0 can
        # be built for the state (a bare loss has no builder: pass params0)
        if is_task(ctx.task):
            task = ctx.task
        else:
            loss_fn = ctx.task
    task, workload, params0, data, eval_data = resolve_workload(
        cfg, task, task_key, loss_fn, params0, data, eval_data,
        need_params=state is None or ctx is None, need_data=ctx is None, device=dev)
    if ctx is None:
        ctx = events_context(cfg, workload, tuple(t.to(dev) for t in data),
                             params0=params0, horizon=horizon, capacity=capacity,
                             tape=tape, tape_seed=tape_seed, graph_seed=graph_seed,
                             scenario=scenario, scenario_key=scenario_key,
                             scenario_kwargs=scenario_kwargs, device=dev)
    else:
        if tape is not None:
            ctx = ctx._replace(tape=tape)
        if ctx.tape is None:
            raise ValueError("the prebuilt ctx carries no EventTape; build it with "
                             "events_context(...) or pass tape=")
    return simulate(algo, cfg, params0=params0,
                    loss_fn=workload if task is None else None,
                    num_steps=ctx.tape.capacity, task=task, key=key,
                    eval_every=eval_every, eval_fn=eval_fn, eval_data=eval_data,
                    ctx=ctx, state=state, device=dev, draws_fn=draws_fn)

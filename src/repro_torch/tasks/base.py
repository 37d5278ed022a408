"""The `Task` abstraction: a (model x optimizer x dataset) workload.

Port of `repro.tasks.base`. A protocol step touches the workload through
a loss to differentiate, a federated dataset to draw batches from, an
update rule and an eval metric; a `Task` bundles them:

  - ``init_params(key)`` -> one client's parameter dict, where ``key``
    is an int seed or a `torch.Generator` (its device is the run's);
  - ``loss_fn(params, x, y)`` over client-stacked params ``(N, ...)``
    and per-client batches ``(N, B, ...)`` -> the ``(N,)`` per-client
    mean losses (the reference vmaps a per-client loss; the port writes
    the client axis out, and the gradient of the sum is exactly the
    per-client gradients, since no client's loss reads another's
    params);
  - ``make_data(key, num_clients)`` -> ``((xs, ys), (ex, ey))``;
  - ``eval_fn(params, ex, ey)`` -> ``(N,)`` per-client metric;
  - ``make_optimizer(lr)`` -> a `repro_torch.optim.Optimizer` whose
    per-client state rides the flat ``(N, Dopt)`` plane next to the
    ``(N, Dflat)`` payloads (`repro_torch.core.protocol.task_local_updates`);
  - ``grad_cost``: relative MFLOPs of one local gradient event;
  - ``sweepable``: what a sweep row may re-bind (the lr).

Tasks register with `register_task` and are cached by `get_task`, so the
same arguments give the same object. Everything downstream also takes a
bare batched loss where a `Task` is expected (plain SGD); `as_task` and
`loss_of` convert between the two.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import as_generator, optim
from repro_torch.core import flat as flat_lib


@dataclass(frozen=True)
class Task:
    """Immutable workload bundle; equal arguments give equal tasks."""

    name: str
    init_params: Callable  # key -> single-client param dict
    loss_fn: Callable  # (params (N,...), x (N,B,...), y (N,B,...)) -> (N,)
    eval_fn: Callable  # (params (N,...), ex, ey) -> (N,)
    make_data: Callable  # (key, num_clients) -> ((xs, ys), (ex, ey))
    metric_name: str = "accuracy"
    opt_name: str = "sgd"  # repro_torch.optim factory name
    schedule: str = "constant"  # lr schedule family
    opt_kwargs: Tuple[Tuple[str, Any], ...] = ()  # (beta, b1, ...) frozen
    schedule_kwargs: Tuple[Tuple[str, Any], ...] = ()
    grad_cost: float = 1.0  # relative MFLOPs of one local gradient event
    # optimizer hyperparameters a sweep may re-bind per grid row (passed to
    # make_optimizer): the lr that seeds the schedule
    sweepable: Tuple[str, ...] = ("lr",)

    def make_optimizer(self, lr: float) -> optim.Optimizer:
        """The local update rule, with `lr` seeding the schedule."""
        sched_fn = _SCHEDULES[self.schedule](lr, **dict(self.schedule_kwargs))
        return _OPTIMIZERS[self.opt_name](sched_fn, **dict(self.opt_kwargs))

    def setup(self, key, num_clients: int, *, device=None):
        """``(params0, train, eval_data)`` from one generator (an int seed
        or a `torch.Generator`): params first, then data."""
        g = as_generator(key, device)
        params0 = self.init_params(g)
        train, eval_data = self.make_data(g, num_clients)
        return params0, train, eval_data

    def with_optimizer(self, opt_name: str, schedule: str = None,
                       schedule_kwargs: dict = None, **opt_kwargs) -> "Task":
        """The same workload under another local update rule.

        Kwargs follow their family: a new optimizer or schedule family
        without new kwargs clears the old family's kwargs; keeping the
        family keeps them."""
        if opt_name not in _OPTIMIZERS:
            raise KeyError(f"unknown optimizer {opt_name!r}; known: {sorted(_OPTIMIZERS)}")
        if schedule is not None and schedule not in _SCHEDULES:
            raise KeyError(f"unknown schedule {schedule!r}; known: {sorted(_SCHEDULES)}")
        if opt_kwargs:
            opt_kw = tuple(sorted(opt_kwargs.items()))
        else:
            opt_kw = self.opt_kwargs if opt_name == self.opt_name else ()
        if schedule_kwargs is not None:
            sched_kw = tuple(sorted(schedule_kwargs.items()))
        elif schedule is None or schedule == self.schedule:
            sched_kw = self.schedule_kwargs
        else:
            sched_kw = ()
        return replace(self, opt_name=opt_name,
                       schedule=self.schedule if schedule is None else schedule,
                       opt_kwargs=opt_kw, schedule_kwargs=sched_kw)

    def __repr__(self):
        return (f"Task({self.name!r}, opt={self.opt_name}/{self.schedule}, "
                f"metric={self.metric_name}, grad_cost={self.grad_cost:.3g})")


_OPTIMIZERS = {
    "sgd": lambda sched: optim.sgd(sched),
    "momentum": optim.momentum,
    "adamw": optim.adamw,
}

_SCHEDULES = {
    "constant": lambda lr: optim.constant_schedule(lr),
    "cosine": optim.cosine_schedule,
    "warmup-cosine": optim.warmup_cosine,
}


def is_task(obj) -> bool:
    return isinstance(obj, Task)


def as_task(loss_or_task, name: str = "<legacy-loss>") -> Optional[Task]:
    """Wrap a bare batched loss into a plain-SGD task (cached on the
    callable, so the same loss gives the same task); `Task`s and None
    pass through."""
    if loss_or_task is None or is_task(loss_or_task):
        return loss_or_task
    if not callable(loss_or_task):
        raise TypeError(f"expected a Task, a loss callable or None; got {loss_or_task!r}")
    if loss_or_task not in _WRAPPED:
        _WRAPPED[loss_or_task] = Task(name=name, init_params=_no_init,
                                      loss_fn=loss_or_task, eval_fn=_no_eval,
                                      make_data=_no_data)
    return _WRAPPED[loss_or_task]


def _no_init(key):
    raise NotImplementedError("a bare-loss task has no model builder; pass params0=")


def _no_eval(params, ex, ey):
    raise NotImplementedError("a bare-loss task has no eval metric; pass eval_fn=")


def _no_data(key, num_clients):
    raise NotImplementedError("a bare-loss task has no dataset builder; pass data=")


_WRAPPED: Dict[Callable, Task] = {}


def loss_of(task_or_loss):
    """The bare loss callable of either representation."""
    return task_or_loss.loss_fn if is_task(task_or_loss) else task_or_loss


def opt_layout(task, params0):
    """The `FlatSpec` of one client's optimizer state (its `dim` is Dopt),
    reckoned from the optimizer's init on shape-only (meta) tensors."""
    meta = flat_lib.tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"), params0)
    state = task.make_optimizer(0.0).init(meta)
    return flat_lib.spec_of(flat_lib.tree_map(lambda s: s.unsqueeze(0), state))


def opt_width(task, params0) -> int:
    """Per-client flat width Dopt of the task's optimizer state (sgd 0,
    momentum Dflat, adamw 2 * Dflat + 1: m, v and its per-client step
    counter); 0 for a bare loss or None."""
    if task is None or not is_task(task):
        return 0
    return opt_layout(task, params0).dim


_BUILDERS: Dict[str, Callable[..., Task]] = {}
_CACHE: Dict[Tuple, Task] = {}


def register_task(name: str):
    """Decorator: register a task *builder* under `name`."""

    def deco(fn):
        _BUILDERS[name] = fn
        return fn

    return deco


def _freeze(v):
    if isinstance(v, dict):
        return ("<dict>",) + tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def get_task(name, **kwargs) -> Task:
    """Resolve (and memoize) a registered task; `Task`s pass through."""
    if is_task(name):
        return name
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise KeyError(
            f"unknown task {name!r}; registered: {sorted(_BUILDERS)}") from None
    cache_key = (name, tuple(sorted((k, _freeze(v)) for k, v in kwargs.items())))
    if cache_key not in _CACHE:
        _CACHE[cache_key] = builder(**kwargs)
    return _CACHE[cache_key]


def list_tasks() -> Tuple[str, ...]:
    return tuple(sorted(_BUILDERS))

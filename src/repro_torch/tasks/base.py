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
  - ``grad_cost``: relative MFLOPs of one local gradient event.

The port has plain SGD with a constant schedule only;
`make_optimizer` raises `NotImplementedError` for anything else (ROADMAP
queue 1 item 8: the rest of ``tasks/zoo.py`` and ``optim/``).
Tasks register with `register_task` and are cached by `get_task`, so the
same arguments give the same object.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

OPTIMIZER_ROADMAP = "ROADMAP.md queue 1 item 8 (tasks/zoo.py and optim/)"


@dataclass(frozen=True)
class Task:
    """Immutable workload bundle (the reference's fields that plain SGD uses)."""

    name: str
    init_params: Callable  # key -> single-client param dict
    loss_fn: Callable  # (params (N,...), x (N,B,...), y (N,B)) -> (N,)
    eval_fn: Callable  # (params (N,...), ex, ey) -> (N,)
    make_data: Callable  # (key, num_clients) -> ((xs, ys), (ex, ey))
    metric_name: str = "accuracy"
    opt_name: str = "sgd"
    schedule: str = "constant"
    grad_cost: float = 1.0

    def make_optimizer(self, lr: float) -> Callable:
        """The local update rule ``(p, g) -> p - lr * g`` (plain SGD,
        constant schedule); other optimizers are not ported yet."""
        if self.opt_name != "sgd" or self.schedule != "constant":
            raise NotImplementedError(
                f"optimizer {self.opt_name}/{self.schedule} is not ported; "
                f"see {OPTIMIZER_ROADMAP}")
        return lambda p, g: p - lr * g

    def __repr__(self):
        return (f"Task({self.name!r}, opt={self.opt_name}/{self.schedule}, "
                f"metric={self.metric_name}, grad_cost={self.grad_cost:.3g})")


def is_task(obj) -> bool:
    return isinstance(obj, Task)


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

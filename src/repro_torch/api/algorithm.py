"""The `Algorithm` interface and its string-keyed registry.

Port of `repro.api.algorithm`. A method is ``init / step / eval_params
/ grads_per_step`` over an opaque per-method state; `simulate` runs any
of them in one loop. Registry instances are singletons.
"""
from __future__ import annotations

from typing import Any, Dict, Protocol, Tuple, runtime_checkable


@runtime_checkable
class Algorithm(Protocol):
    """`init(key, cfg, params0, task=None, *, device=None)` replicates one
    client's params into the method's state; `step(state, ctx,
    draws=None)` advances one round/window (`draws` injects its random
    outcomes); `step_index(state)` is the host-int count of steps the
    state has taken (`window_idx`, `round_idx`); `eval_params(state)` is
    the (N, ...) view metrics read; `grads_per_step(cfg)` is the expected
    local gradient events per client per step.

    For `simulate_sweep` an algorithm also declares `sweepable`, the
    config fields a grid row may re-bind, and `seed_axis`: True when its
    `step` advances a seed-stacked `DracoState` (`protocol.stack_seeds`)
    in one pass, False when the sweep runs the seeds one solo state after
    another."""

    name: str

    def init(self, key, cfg, params0, task=None, *, device=None) -> Any:
        ...

    def step(self, state, ctx, draws=None) -> Any:
        ...

    def step_index(self, state) -> int:
        ...

    def eval_params(self, state) -> Any:
        ...

    def grads_per_step(self, cfg) -> float:
        ...


_REGISTRY: Dict[str, Algorithm] = {}


def register_algorithm(name: str):
    """Class decorator: instantiate once and register under `name`."""

    def deco(cls):
        algo = cls() if isinstance(cls, type) else cls
        algo.name = name
        _REGISTRY[name] = algo
        return cls

    return deco


def get_algorithm(name: str) -> Algorithm:
    """Resolve a registered algorithm (always the same singleton)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown algorithm {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))

"""`repro_torch.api` — the algorithm registry and the simulation driver.

    from repro_torch.api import simulate

    state, trace = simulate("draco", cfg, task="mlp", num_steps=300,
                            key=0, eval_every=100)
    print(trace.metrics["accuracy"])
"""
from repro_torch.api.algorithm import (
    Algorithm,
    get_algorithm,
    list_algorithms,
    register_algorithm,
)
from repro_torch.api.context import SimContext, make_context
from repro_torch.api.simulate import (
    SimTrace,
    consensus_distance,
    resolve_workload,
    simulate,
    steps_for_budget,
)

# importing the module registers the built-in algorithms
from repro_torch.api import algorithms  # noqa: F401

__all__ = [
    "Algorithm", "SimContext", "SimTrace", "consensus_distance",
    "get_algorithm", "list_algorithms", "make_context", "register_algorithm",
    "resolve_workload", "simulate", "steps_for_budget",
]

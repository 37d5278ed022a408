"""`repro_torch.api` — the algorithm registry and the simulation driver.

    from repro_torch.api import simulate

    state, trace = simulate("draco", cfg, task="mlp", num_steps=300,
                            key=0, eval_every=100)
    print(trace.metrics["accuracy"])

    # a Psi grid over 4 seeds in one call: metrics (G, R, num_evals)
    finals, sweep = simulate_sweep("draco", [cfg.replace(psi=p) for p in (1, 4)],
                                   task="mlp", num_steps=300, key=0, num_seeds=4,
                                   eval_every=100)
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
from repro_torch.api.sweep import SweepTrace, simulate_sweep, stack_configs

# importing the module registers the built-in algorithms
from repro_torch.api import algorithms  # noqa: F401

# the event family registers on import, and its driver is re-exported
# (repro_torch.events defers its api imports, so this is cycle-free)
from repro_torch.events import events_context, simulate_events  # noqa: E402

__all__ = [
    "Algorithm", "SimContext", "SimTrace", "consensus_distance", "events_context",
    "get_algorithm", "list_algorithms", "make_context", "register_algorithm",
    "resolve_workload", "simulate", "simulate_events", "simulate_sweep", "stack_configs",
    "steps_for_budget", "SweepTrace",
]

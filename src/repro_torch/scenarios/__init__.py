"""Time-varying simulation workloads (port of `repro.scenarios`).

A generator builds a `Schedule` of device rings ``(q_t, adj_t, w_sym_t,
positions_t, compute_rate_t, tx_rate_t)`` once per run; every step reads
``schedule.at(step)``:

    from repro_torch.api import simulate
    state, trace = simulate("draco", cfg, task="mlp", num_steps=600, key=0,
                            scenario="markov-edge-flip",
                            scenario_kwargs={"churn": 0.2})

Built-ins: ``static``, ``markov-edge-flip``, ``random-waypoint``,
``straggler-profile``; new generators register with
`register_scenario`.
"""
from repro_torch.scenarios.base import (
    Schedule,
    Snapshot,
    check_snapshot,
    get_scenario,
    list_scenarios,
    make_schedule,
    register_scenario,
    validate_schedule,
)

# importing the module registers the built-in generators
from repro_torch.scenarios import generators  # noqa: F401

__all__ = [
    "Schedule",
    "Snapshot",
    "check_snapshot",
    "generators",
    "get_scenario",
    "list_scenarios",
    "make_schedule",
    "register_scenario",
    "validate_schedule",
]

"""`repro_torch.events` — the continuous-time event engine (port of
`repro.events`).

The windowed engine discretizes DRACO's merged Poisson point process
into superposition windows; this package keeps the exact timeline:

    from repro_torch.events import EventConfig, simulate_events

    cfg = EventConfig(num_clients=25, staleness="poly")
    state, trace = simulate_events("fedasync-gossip", cfg,
                                   task="linear-softmax", horizon=200.0,
                                   key=0, eval_every=500)

Pieces: `tape` samples each run on the host into a sorted fixed-length
`EventTape`; `engine` walks it one event at a time, draining through the
hand-written drain kernel; `replay` is the eager oracle (bit for bit on
the CPU); `algorithms` registers the family (draco-event,
fedasync-gossip, event-triggered, fedasync-window); `driver` routes
everything through `repro_torch.api.simulate`, so `simulate_sweep` grids
work unchanged.
"""
from repro_torch.events.config import EventConfig, STALENESS_MODES
from repro_torch.events.tape import (
    EventTape,
    KIND_GRAD,
    KIND_TX,
    KIND_UNIFY,
    profiled_event_list,
    sample_event_tape,
    tape_capacity,
    tape_from_events,
)
from repro_torch.events.staleness import (
    staleness_damping_vector,
    staleness_fn,
    staleness_scale,
)
from repro_torch.events.engine import (
    EventDraws,
    EventState,
    event_step,
    init_event_state,
    run_events,
    sample_event_draws,
)
from repro_torch.events.replay import ReplayResult, replay_events
from repro_torch.events.driver import events_context, simulate_events

# importing the module registers the event algorithm family
from repro_torch.events import algorithms  # noqa: F401  (import side effect)

__all__ = [
    "EventConfig",
    "EventDraws",
    "EventState",
    "EventTape",
    "KIND_GRAD",
    "KIND_TX",
    "KIND_UNIFY",
    "ReplayResult",
    "STALENESS_MODES",
    "algorithms",
    "event_step",
    "events_context",
    "init_event_state",
    "profiled_event_list",
    "replay_events",
    "run_events",
    "sample_event_draws",
    "sample_event_tape",
    "simulate_events",
    "staleness_damping_vector",
    "staleness_fn",
    "staleness_scale",
    "tape_capacity",
    "tape_from_events",
]

"""`EventConfig`: `DracoConfig` plus the event family's knobs (port of
`repro.events.config`).

A plain `DracoConfig` runs every event algorithm with the defaults below
(the algorithms read these fields with ``getattr`` and the same
fallbacks); `EventConfig` makes them explicit and validated.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.protocol import DracoConfig

STALENESS_MODES = ("constant", "hinge", "poly")


@dataclass(frozen=True)
class EventConfig(DracoConfig):
    # FedAsync-style staleness damping s(delta_tau) of arriving message
    # weights, delta_tau in superposition windows:
    #   constant: s = 1 (no damping; draco-event bit for bit)
    #   hinge:    s = 1 if dt <= b else 1 / (a * (dt - b) + 1)
    #   poly:     s = (dt + 1) ** (-a)
    staleness: str = "constant"
    staleness_a: float = 0.5
    staleness_b: float = 4.0
    # event-triggered broadcast suppression: a transmission event fires
    # only if the sender's pending backlog has ||Delta||_2 >=
    # trigger_threshold (0 = always fire)
    trigger_threshold: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if self.staleness not in STALENESS_MODES:
            raise ValueError(
                f"staleness must be one of {STALENESS_MODES}, "
                f"got {self.staleness!r}")
        if self.staleness_a <= 0:
            raise ValueError(
                f"staleness_a must be positive, got {self.staleness_a}")
        if self.staleness_b < 0:
            raise ValueError(
                f"staleness_b must be >= 0, got {self.staleness_b}")
        if self.trigger_threshold < 0:
            raise ValueError(
                "trigger_threshold must be >= 0 (0 = always fire), "
                f"got {self.trigger_threshold}")

"""Sorted fixed-length event tapes: the continuous timeline, on the host
(port of `repro.events.tape`).

The windowed engine discretizes the paper's merged Poisson point process
(Assumption 1) into superposition windows; the event engine keeps the
exact timeline. Each run's merged process (per-client gradient events
at ``lambda_grad``, transmissions at ``lambda_tx``, periodic
unifications) is sampled on the host into one sorted **event tape** of
parallel ``(E,)`` numpy arrays

    t      f32   event time (seconds, ascending)
    client i32   acting client (the rotating hub for unify events)
    kind   i32   KIND_GRAD | KIND_TX | KIND_UNIFY
    valid  bool  padding mask (False rows are strict no-ops)

padded to a fixed length as the reference pads its tapes. The port's
engine dispatches on the tape in Python, one event at a time, so the
tape stays numpy on the host and reading it costs no device sync.

Sizing rule: the merged process has mean ``horizon * sum_i (lam_grad_i
+ lam_tx_i)`` events; `tape_capacity` allocates mean + 6 sigma plus the
unification count. `tape_from_events` raises rather than truncate.

Scenario profiles: with ``schedule=``, candidates are drawn at each
client's peak rate ``lam * max(ring)`` and kept with probability
``rate(t) / peak``, where ``rate(t)`` reads the ring at window
``floor(t / window) % T``, the lookup the windowed engine makes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.events import Event, event_list, unify_hub

KIND_GRAD = 0
KIND_TX = 1
KIND_UNIFY = 2

_KIND_CODE = {"grad": KIND_GRAD, "tx": KIND_TX, "unify": KIND_UNIFY}
KIND_NAMES = ("grad", "tx", "unify")


class EventTape(NamedTuple):
    """The sampled merged timeline as fixed-length host arrays."""

    t: np.ndarray  # (E,) f32, ascending over valid rows
    client: np.ndarray  # (E,) i32
    kind: np.ndarray  # (E,) i32 (KIND_GRAD | KIND_TX | KIND_UNIFY)
    valid: np.ndarray  # (E,) bool — False rows are padding (strict no-ops)

    @property
    def capacity(self) -> int:
        return int(self.t.shape[0])

    @property
    def num_valid(self) -> int:
        """Count of real (non-padding) events."""
        return int(self.valid.sum())

    def counts(self) -> dict:
        """Events per kind (tests, benchmarks)."""
        k = self.kind[self.valid]
        return {name: int((k == code).sum()) for name, code in _KIND_CODE.items()}


def tape_from_events(events: Sequence[Event],
                     capacity: Optional[int] = None) -> EventTape:
    """Pack an exact `event_list` timeline into an `EventTape`, in the
    list's order (already time-sorted). `capacity` pads with masked rows
    to a fixed length; an overflow raises rather than silently dropping
    the tail of the run."""
    n_ev = len(events)
    cap = n_ev if capacity is None else int(capacity)
    if n_ev > cap:
        raise ValueError(
            f"{n_ev} events exceed tape capacity {cap}; size it with "
            "tape_capacity(cfg, horizon, ...) (mean + 6 sigma)")
    t = np.zeros((cap,), np.float32)
    client = np.zeros((cap,), np.int32)
    kind = np.zeros((cap,), np.int32)
    valid = np.zeros((cap,), bool)
    for i, e in enumerate(events):
        t[i] = e.t
        client[i] = e.client
        kind[i] = _KIND_CODE[e.kind]
        valid[i] = True
    if n_ev:
        t[n_ev:] = t[n_ev - 1]  # padding keeps time monotone (cosmetic)
    return EventTape(t, client, kind, valid)


def _ring(x) -> Optional[np.ndarray]:
    """A schedule's rate ring as a host array (None stays None)."""
    if x is None:
        return None
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


def _peak_rates(cfg, schedule=None):
    """Per-client peak (lam_grad_i, lam_tx_i) after rate-ring modulation."""
    n = cfg.num_clients
    lam_g = np.broadcast_to(np.asarray(cfg.lambda_grad, np.float64), (n,))
    lam_t = np.broadcast_to(np.asarray(cfg.lambda_tx, np.float64), (n,))
    if schedule is not None:
        if schedule.compute_rate is not None:
            lam_g = lam_g * _ring(schedule.compute_rate).max(axis=0)
        if schedule.tx_rate is not None:
            lam_t = lam_t * _ring(schedule.tx_rate).max(axis=0)
    return lam_g, lam_t


def tape_capacity(cfg, horizon: float, schedule=None, sigmas: float = 6.0) -> int:
    """The ``E`` sizing rule: mean merged-process count + `sigmas` std,
    at each client's peak ring-modulated rate, plus the unifications."""
    lam_g, lam_t = _peak_rates(cfg, schedule)
    mean = float(horizon) * float(lam_g.sum() + lam_t.sum())
    cap = int(np.ceil(mean + sigmas * np.sqrt(max(mean, 1.0)))) + 1
    if cfg.unify_period > 0:
        period_s = cfg.unify_period * cfg.window
        cap += int(np.ceil(horizon / period_s))
    return cap


def _thinned_times(rng: np.random.Generator, lam: float, horizon: float,
                   ring: np.ndarray, window: float) -> List[float]:
    """Non-homogeneous Poisson times by thinning against a rate ring: the
    rate is ``lam * ring[floor(t/window) % T]``, candidates at the peak
    rate, each kept with probability rate(t) / peak."""
    peak = lam * float(ring.max())
    if peak <= 0:
        return []
    out: List[float] = []
    t = rng.exponential(1.0 / peak)
    while t < horizon:
        mult = float(ring[int(t // window) % len(ring)])
        if rng.uniform() < (lam * mult) / peak:
            out.append(float(t))
        t += rng.exponential(1.0 / peak)
    return out


def profiled_event_list(rng: np.random.Generator, cfg, horizon: float,
                        schedule) -> List[Event]:
    """Exact merged timeline under a scenario schedule's rate rings."""
    n = cfg.num_clients
    lam_g = np.broadcast_to(np.asarray(cfg.lambda_grad, np.float64), (n,))
    lam_t = np.broadcast_to(np.asarray(cfg.lambda_tx, np.float64), (n,))
    ones = np.ones((1, n))
    ring_g = _ring(schedule.compute_rate) if schedule.compute_rate is not None else ones
    ring_t = _ring(schedule.tx_rate) if schedule.tx_rate is not None else ones
    events: List[Event] = []
    for i in range(n):
        for lam, ring, kind in ((lam_g[i], ring_g[:, i], "grad"),
                                (lam_t[i], ring_t[:, i], "tx")):
            for t in _thinned_times(rng, float(lam), horizon, ring, cfg.window):
                events.append(Event(t, i, kind))
    if cfg.unify_period > 0:
        period_s = cfg.unify_period * cfg.window
        k = 1
        while k * period_s < horizon:
            events.append(Event(float(k * period_s), unify_hub(k, n), "unify"))
            k += 1
    events.sort(key=lambda e: e.t)
    return events


def sample_event_tape(cfg, horizon: float, *, seed=0,
                      rng: Optional[np.random.Generator] = None,
                      schedule=None, capacity: Optional[int] = None) -> EventTape:
    """Sample one run's merged timeline (`seed` or an explicit numpy
    `rng`: the reference's `event_list` process, so equal seeds give equal
    tapes in both packages) and pack it; with `schedule=`, its rate rings
    thin the process (`profiled_event_list`). `capacity` defaults to
    `tape_capacity`."""
    if rng is None:
        rng = np.random.default_rng(seed)
    if capacity is None:
        capacity = tape_capacity(cfg, horizon, schedule)
    if schedule is not None and (schedule.compute_rate is not None
                                 or schedule.tx_rate is not None):
        events = profiled_event_list(rng, cfg, horizon, schedule)
    else:
        events = event_list(rng, cfg.num_clients, horizon, cfg.lambda_grad, cfg.lambda_tx,
                            unify_period=cfg.unify_period * cfg.window)
    return tape_from_events(events, capacity)

"""Poisson event machinery (paper Sec. 2.3, Assump. 1).

Port of `repro.core.events`. Two views of the same point process:

  - the superposition-window view of the windowed engine: for a window
    of length w, a client fires iff its Poisson process has >= 1 point
    in the window, ``P = 1 - exp(-lambda w)`` (`sample_event_masks`);
  - the exact event-driven timeline (`event_list`, host numpy), which
    the continuous-time event engine (`repro_torch.events`) packs into a
    tape. `event_list`, `Event`, `unify_hub` and
    `poisson_truncation_bound` are the reference's numpy code, copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


def window_event_probs(lam, window: float):
    """P(at least one event in a window) per client, in f32.

    A tensor rate gives a tensor; a Python rate gives a numpy f32 scalar
    computed on the host, so a window never copies a host value to the
    card (a blocking copy would stall the loop on the device)."""
    if isinstance(lam, torch.Tensor):
        return 1.0 - torch.exp(-lam.to(torch.float32) * window)
    return np.float32(1.0) - np.exp(-np.float32(lam) * np.float32(window))


def sample_event_masks(generator: torch.Generator, lam, window: float,
                       n: int) -> torch.Tensor:
    """(n,) bool on the generator's device: uniform draw < event prob."""
    u = torch.rand((n,), generator=generator, device=generator.device)
    p = window_event_probs(lam, window)
    return u < (p if isinstance(p, torch.Tensor) else float(p))


def poisson_truncation_bound(lamw_max: float, sigmas: float = 6.0) -> int:
    """Truncation cap for a Poisson(lam*w) count: mean + `sigmas` std
    deviations (Poisson variance == mean), floored at a small constant so
    near-zero rates still admit the occasional event."""
    hi = max(float(lamw_max), 0.0)
    return int(np.ceil(hi + sigmas * np.sqrt(max(hi, 1.0)))) + 1


def sample_event_counts(generator: torch.Generator, lam, window: float, n: int,
                        max_count=None) -> torch.Tensor:
    """(n,) int64 on the generator's device: the number of events in the
    window, a Poisson(lam * w) draw clipped to ``[0, max_count]``.

    ``max_count=None`` sizes the cap from the rate itself
    (`poisson_truncation_bound`, mean + 6 sigma), so high-rate clients
    keep their tail mass; an explicit ``max_count`` keeps the truncated
    behaviour. `lam` is a Python number or an (n,) tensor (read on the
    host for the default cap)."""
    dev = generator.device
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    lamw = torch.broadcast_to(lam_t * window, (n,)).contiguous()
    if max_count is None:
        peak = float(lam_t.max()) if isinstance(lam, torch.Tensor) else float(np.max(lam))
        max_count = poisson_truncation_bound(peak * window)
    counts = torch.poisson(lamw, generator=generator)
    return torch.clamp(counts, 0, max_count).to(torch.int64)


@dataclass
class Event:
    t: float
    client: int
    kind: str  # "grad" | "tx" | "unify"


def unify_hub(k: int, n: int) -> int:
    """Hub of the k-th unification (k = 1, 2, ...) under the rotating-hub
    rule shared with the window engine: `protocol._unify` fires at the end
    of window ``k*P - 1`` with ``hub = (widx // P) % n = (k - 1) % n``."""
    return (k - 1) % n


def event_list(rng: np.random.Generator, n: int, horizon: float,
               lam_grad, lam_tx, unify_period: float = 0.0,
               random_hub: bool = False) -> List[Event]:
    """Exact merged continuous-time event list (Algorithm 2 lines 1-15),
    sorted by time.

    Per client, gradient events at `lam_grad` and transmissions at
    `lam_tx` (scalars or per-client), exponential gaps from `rng`;
    unifications every `unify_period` seconds on the rotating hub
    (`unify_hub`), or, with `random_hub`, a uniform-random hub (one more
    rng draw per unification)."""
    lam_grad = np.broadcast_to(np.asarray(lam_grad, np.float64), (n,))
    lam_tx = np.broadcast_to(np.asarray(lam_tx, np.float64), (n,))
    events: List[Event] = []
    for i in range(n):
        for lam, kind in ((lam_grad[i], "grad"), (lam_tx[i], "tx")):
            if lam <= 0:
                continue
            t = rng.exponential(1.0 / lam)
            while t < horizon:
                events.append(Event(float(t), i, kind))
                t += rng.exponential(1.0 / lam)
    if unify_period and unify_period > 0:
        k = 1
        while k * unify_period < horizon:
            hub = int(rng.integers(0, n)) if random_hub else unify_hub(k, n)
            events.append(Event(float(k * unify_period), hub, "unify"))
            k += 1
    events.sort(key=lambda e: e.t)
    return events

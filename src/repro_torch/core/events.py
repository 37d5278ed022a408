"""Superposition-window Poisson thinning (paper Sec. 2.3, Assump. 1).

Port of the window view of `repro.core.events`: for a window of length
w, a client fires iff its Poisson process has >= 1 point in the window,
``P = 1 - exp(-lambda w)``.
"""
from __future__ import annotations

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

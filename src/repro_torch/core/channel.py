"""Unreliable wireless channel model (paper Sec. 5).

Port of `repro.core.channel`. Transmission time from i to j:
    Gamma_ij = msg_bytes*8 / (W log2(1 + SINR_ij)) + dist(i,j)/c
    SINR_ij  = P h_ij d_ij^-a / (sum_{n in interferers(j)} P h_nj d_nj^-a + z^2)
with Rayleigh fading h ~ exp(1) drawn per transmission. A message is
lost iff Gamma_ij > Gamma_max. Nodes interfere when within 0.1*R.

Defaults follow the paper: R=500 m, P=30 dBm, alpha=4, W=10 MHz,
N0=-174 dBm/Hz.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LIGHTSPEED = 3.0e8


@dataclass(frozen=True)
class ChannelConfig:
    radius: float = 500.0  # m
    tx_power_dbm: float = 30.0
    path_loss_exp: float = 4.0
    bandwidth_hz: float = 10e6
    noise_dbm_hz: float = -174.0
    interference_radius_frac: float = 0.1
    message_bytes: int = 596_776
    gamma_max: float = 10.0  # s, delay deadline
    enabled: bool = True

    @property
    def tx_power_w(self) -> float:
        return 10 ** (self.tx_power_dbm / 10) / 1e3

    @property
    def noise_w(self) -> float:
        return 10 ** (self.noise_dbm_hz / 10) / 1e3 * self.bandwidth_hz


def place_nodes(generator: torch.Generator, n: int,
                cfg: ChannelConfig) -> torch.Tensor:
    """Uniform positions in a disk of radius R, (n, 2) f32, on the
    generator's device."""
    dev = generator.device
    r = cfg.radius * torch.sqrt(torch.rand((n,), generator=generator, device=dev))
    th = 2 * math.pi * torch.rand((n,), generator=generator, device=dev)
    return torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)


def pairwise_dist(pos: torch.Tensor) -> torch.Tensor:
    """(n, n) Euclidean distances, clamped to 1 m (no singular path loss)."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))
    return torch.clamp(d, min=1.0)


def interference(dist, p_rx, tx_mask, cfg: ChannelConfig) -> torch.Tensor:
    """Aggregate interference on each link i -> j, (n, n).

    Total received power at j from concurrently transmitting nodes within
    the interference radius, minus i's own signal when i is itself close.
    The self-subtraction removes one term of the sum it was part of, so
    the result is non-negative up to f32 rounding; the clamp absorbs that
    rounding.
    """
    close = dist <= cfg.interference_radius_frac * cfg.radius  # [n, j]
    contrib = torch.where(close & tx_mask[..., :, None], p_rx, 0.0)
    interf = contrib.sum(dim=-2)[..., None, :] - contrib
    return torch.clamp(interf, min=0.0)


def transmission_delays(fading, pos, tx_mask, cfg: ChannelConfig):
    """Per-link delay Gamma (n, n) [seconds] and success mask.

    `fading` (n, n) is the link's exp(1) Rayleigh draw (the reference
    draws it from its key here); `tx_mask` (n,) marks the concurrently
    transmitting nodes, which interfere. Entry [i, j] is the link i -> j;
    success = Gamma <= gamma_max and i transmits. Leading seed axes of
    `fading`, `pos` and `tx_mask` ride along.
    """
    dist = pairwise_dist(pos)
    p_rx = cfg.tx_power_w * fading * dist ** (-cfg.path_loss_exp)
    sinr = p_rx / (interference(dist, p_rx, tx_mask, cfg) + cfg.noise_w)
    rate = cfg.bandwidth_hz * torch.log2(1.0 + sinr)
    gamma = (cfg.message_bytes * 8) / torch.clamp(rate, min=1e-9) + dist / LIGHTSPEED
    success = (gamma <= cfg.gamma_max) & tx_mask[..., :, None]
    return gamma, success


def geometric_adjacency(pos: torch.Tensor, max_range: float) -> torch.Tensor:
    """Boolean links from channel geometry: i -> j iff dist(i, j) <=
    max_range, zero diagonal (the random-waypoint scenario's graph)."""
    n = pos.shape[0]
    return (pairwise_dist(pos) <= max_range) & ~torch.eye(n, dtype=torch.bool,
                                                         device=pos.device)


def waypoint_step(pos: torch.Tensor, waypoints: torch.Tensor, speed: float):
    """One random-waypoint hop: each node moves `speed` meters toward its
    target, snapping onto targets within reach. Returns ``(new_pos (n,
    2), arrived (n,) bool)``; the caller resamples arrived nodes' targets."""
    d = waypoints - pos
    dist = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    arrived = dist[..., 0] <= speed
    step = d / torch.clamp(dist, min=1e-9) * speed
    return torch.where(arrived[:, None], waypoints, pos + step), arrived

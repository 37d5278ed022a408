"""The built-in scenario generators (port of `repro.scenarios.generators`).

  - ``static``: the frozen graph as a period-1 ring; from the same seed it
    is the scenario-less path's graph, bit for bit;
  - ``markov-edge-flip``: per-edge on/off Markov chains at a tunable
    churn and stationary density, re-normalized row-stochastic each step;
  - ``random-waypoint``: node mobility in the deployment disk; each
    step's graph and Q come from the geometry (links within range,
    weights by capped path gain), and the position ring feeds the channel;
  - ``straggler-profile``: the frozen graph with time-varying per-client
    compute rates (heavy-tailed slowdowns, duty cycles).

Each is a numpy core that takes its initial state (a base adjacency, or
positions and waypoints) and an `np.random.Generator`, in the reference's
draw order, wrapped by a registered builder that seeds it from an int or
a `torch.Generator` and returns the rings on the run's device. All of it
runs on the host, once per run.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.topology import adjacency, metropolis, row_stochastic
from repro_torch.scenarios.base import Schedule, register_scenario


def _seed(key) -> int:
    """An int seed from an int (itself), None (0) or a `torch.Generator`
    (one draw from it)."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2**31 - 1, (), generator=key, device=key.device))
    return 0 if key is None else int(key)


def _cycle_overlay(a: np.ndarray) -> np.ndarray:
    """Always-on bidirectional Hamiltonian cycle: every snapshot stays
    strongly connected (and its symmetrization connected)."""
    n = a.shape[0]
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = True
    a[(idx + 1) % n, idx] = True
    return a


def _rings_from_adjs(adjs, weights=None, device=None) -> Schedule:
    """Stack per-step adjacencies (and link weights) into q/adj/w_sym rings."""
    adj = torch.as_tensor(np.stack(adjs), device=device)
    w = None if weights is None else torch.as_tensor(np.stack(weights), device=device)
    qs = [row_stochastic(a, None if w is None else w[t]) for t, a in enumerate(adj)]
    return Schedule(q=torch.stack(qs), adj=adj,
                    w_sym=torch.stack([metropolis(a) for a in adj]))


def _static_rings(adj: torch.Tensor) -> Schedule:
    return Schedule(q=row_stochastic(adj)[None], adj=adj[None],
                    w_sym=metropolis(adj)[None])


@register_scenario("static")
def static(cfg, key=None, *, device=None) -> Schedule:
    """The frozen graph as a period-1 ring: `adjacency`, `row_stochastic`
    and `metropolis` with the seed the frozen path's ``graph_seed`` would
    be, so a static run equals the scenario-less one bit for bit."""
    seed = key if key is None else _seed(key)
    return _static_rings(adjacency(cfg.topology, cfg.num_clients, seed=seed,
                                   device=resolve_device(device)))


def markov_edge_flip_adjs(base: np.ndarray, rng: np.random.Generator,
                          steps: int = 32, churn: float = 0.1,
                          density: Optional[float] = None,
                          keep_connected: bool = True) -> List[np.ndarray]:
    """Per-step adjacencies of per-edge on/off Markov chains over all
    directed pairs, starting from `base` (step 0 is `base`).

    P(on -> off) = churn and P(off -> on) = churn * density / (1 -
    density), so the stationary density is `density` (default: the base
    graph's); where the off -> on rate would pass 1 both are scaled down
    together, which keeps the density."""
    n = base.shape[0]
    off_diag = ~np.eye(n, dtype=bool)
    if density is None:
        density = float(base[off_diag].mean())
    density = float(np.clip(density, 0.05, 0.95))
    p_on_off = float(np.clip(churn, 0.0, 1.0))
    p_off_on = p_on_off * density / (1.0 - density)
    if p_off_on > 1.0:
        p_on_off, p_off_on = p_on_off / p_off_on, 1.0
    edges = base.copy()
    adjs = []
    for _ in range(int(steps)):
        a = edges & off_diag
        if keep_connected:
            a = _cycle_overlay(a.copy())
        adjs.append(a)
        u = rng.random((n, n))
        edges = np.where(edges, u >= p_on_off, u < p_off_on) & off_diag
    return adjs


@register_scenario("markov-edge-flip")
def markov_edge_flip(cfg, key=None, *, device=None, steps: int = 32,
                     churn: float = 0.1, density: Optional[float] = None,
                     keep_connected: bool = True) -> Schedule:
    """Edge churn over the config's topology (`markov_edge_flip_adjs`)."""
    seed = _seed(key)
    base = adjacency(cfg.topology, cfg.num_clients, seed=seed).numpy().copy()
    adjs = markov_edge_flip_adjs(base, np.random.default_rng((seed, 1)), steps, churn,
                                 density, keep_connected)
    return _rings_from_adjs(adjs, device=resolve_device(device))


def _disk_points(rng: np.random.Generator, m: int, radius: float) -> np.ndarray:
    r = radius * np.sqrt(rng.random(m))
    th = 2 * np.pi * rng.random(m)
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)


def random_waypoint_rings(pos0: np.ndarray, wp0: np.ndarray, rng: np.random.Generator,
                          chan: ChannelConfig, steps: int = 32, speed: float = 25.0,
                          comm_radius_frac: float = 0.5, gain_cap: float = 16.0,
                          keep_connected: bool = True):
    """Random-waypoint mobility from positions `pos0` and targets `wp0`
    (n, 2): each step every node moves `speed` m toward its target and
    draws a new one from `rng` on arrival. Each step links the nodes
    within ``comm_radius_frac * R`` and weights the links by path gain
    relative to the range's edge, ``(d / range)^-alpha``, capped at
    `gain_cap`. Returns ``(positions (T, n, 2) f32, adjs, gains)``."""
    pos = torch.as_tensor(np.array(pos0, np.float32))
    wp = np.asarray(wp0, np.float32).copy()
    max_range = comm_radius_frac * chan.radius
    traj, adjs, gains = [], [], []
    for _ in range(int(steps)):
        traj.append(pos.numpy().copy())
        dist = channel_lib.pairwise_dist(pos).numpy()
        a = channel_lib.geometric_adjacency(pos, max_range).numpy()
        if keep_connected:
            a = _cycle_overlay(a.copy())
        adjs.append(a)
        g = (dist / max_range) ** (-chan.path_loss_exp)
        gains.append(np.minimum(g, gain_cap).astype(np.float32))
        pos, arrived = channel_lib.waypoint_step(pos, torch.as_tensor(wp), speed)
        arrived = arrived.numpy()
        if arrived.any():
            wp[arrived] = _disk_points(rng, int(arrived.sum()), chan.radius)
    return np.stack(traj), adjs, gains


@register_scenario("random-waypoint")
def random_waypoint(cfg, key=None, *, device=None, steps: int = 32,
                    speed: float = 25.0, comm_radius_frac: float = 0.5,
                    gain_cap: float = 16.0, keep_connected: bool = True) -> Schedule:
    """Mobility-derived graphs and a position ring (`random_waypoint_rings`);
    the initial positions and targets are uniform in the disk."""
    chan = cfg.channel or ChannelConfig()
    rng = np.random.default_rng(_seed(key))
    n = cfg.num_clients
    pos0 = _disk_points(rng, n, chan.radius)
    wp0 = _disk_points(rng, n, chan.radius)
    traj, adjs, gains = random_waypoint_rings(pos0, wp0, rng, chan, steps, speed,
                                              comm_radius_frac, gain_cap, keep_connected)
    dev = resolve_device(device)
    return _rings_from_adjs(adjs, gains, dev)._replace(
        positions=torch.as_tensor(traj, dtype=torch.float32, device=dev))


def straggler_rates(n: int, rng: np.random.Generator, steps: int = 32,
                    straggler_frac: float = 0.3, slowdown: float = 10.0,
                    duty: float = 1.0, tail: float = 1.5) -> np.ndarray:
    """(steps, n) f32 per-client rate multipliers: a `straggler_frac`
    subset runs at 1 / (slowdown * (1 + Pareto(tail))), gated by a duty
    cycle of phase drawn per client (`duty` = the powered fraction of the
    period); the others run at 1."""
    T = int(steps)
    num_slow = int(round(np.clip(straggler_frac, 0.0, 1.0) * n))
    slow = np.zeros((n,), bool)
    slow[rng.choice(n, size=num_slow, replace=False)] = True
    factor = np.where(slow, slowdown * (1.0 + rng.pareto(tail, n)), 1.0)
    rate = np.tile(1.0 / factor, (T, 1))
    if duty < 1.0:
        on_steps = max(1, int(round(duty * T)))
        phase = rng.integers(0, T, size=n)
        t_idx = (np.arange(T)[:, None] - phase[None, :]) % T
        rate = rate * ((t_idx < on_steps) | ~slow[None, :])
    return rate.astype(np.float32)


@register_scenario("straggler-profile")
def straggler_profile(cfg, key=None, *, device=None, steps: int = 32,
                      straggler_frac: float = 0.3, slowdown: float = 10.0,
                      duty: float = 1.0, tail: float = 1.5,
                      modulate_tx: bool = False) -> Schedule:
    """The frozen graph with a straggler rate ring (`straggler_rates`) on
    lambda_grad (and lambda_tx too with `modulate_tx`); the baselines
    read it as a participation probability."""
    seed = _seed(key)
    dev = resolve_device(device)
    rate = torch.as_tensor(
        straggler_rates(cfg.num_clients, np.random.default_rng((seed, 1)), steps,
                        straggler_frac, slowdown, duty, tail), device=dev)
    sched = _static_rings(adjacency(cfg.topology, cfg.num_clients, seed=seed, device=dev))
    return sched._replace(compute_rate=rate, tx_rate=rate if modulate_tx else None)

"""The paper's four comparison baselines (Sec. 5).

Port of `repro.core.baselines`:

  - sync-symm : synchronous decentralized SGD with symmetric doubly
                stochastic (Metropolis) mixing;
  - sync-push : synchronous push-sum over the directed graph;
  - async-symm: asynchronous (partial participation + delay deadline)
                with symmetric mixing among surviving links;
  - async-push: asynchronous push-sum gossip (Digest-style).

All share DRACO's local step (`protocol.local_step`), so comparisons
isolate the communication protocol. Each round ends in one mix of the
clients' parameters, ``out_i = sum_j w[i, j] p_j``: on the flat ``(N,
Dflat)`` plane that is ``gossip_mix(w.T, plane)``, one launch of the
hand-written mix kernel (``kernels/gossip/csrc/mix.cu``) per round on
the card. The weights are built on the device; nothing in a round reads
the device.

A `Task`'s local optimizer state rides ``BaselineState.opt_state`` (N,
Dopt), as on `DracoState`. Every round takes a scenario schedule's step-t
``positions`` (the channel's node coordinates, carried on) and
``compute_rate`` (each client's participation probability is scaled by
it; the sync rounds then draw a participation mask they otherwise skip).

Randomness, as in `protocol`: a round's random outcomes are one
`RoundDraws` record, drawn from the state's `torch.Generator` in
production and injected by tests from the reference's key ladder.

A client mesh (`repro_torch.launch.mesh.Mesh`, each round function's
``mesh=``): the state holds this rank's clients (`shard_state`: the rows
of ``params`` and ``opt_state``); the draws, the channel, the weights and
the push weights are computed N-wide on every rank from the same
generator, so every rank takes the same decisions. The local step runs
on the rank's rows, and the mix is `launch.steps.mesh_mix`'s dense mode:
the drain kernel's rectangular tile over one bucket (the rank's sender
rows of ``w.T`` against every receiver), then one reduce-scatter. The
reference mixes by a per-leaf einsum on one device and lets GSPMD shard
it; the kernel on one device and the tile on a mesh are the port's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import as_generator
from repro_torch.core import channel as channel_lib
from repro_torch.core import flat as flat_lib
from repro_torch.core import protocol
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.protocol import DracoConfig, local_step, opt_plane
from repro_torch.core.topology import adjacency, metropolis
from repro_torch.kernels.gossip import ops as gossip_ops

BASELINES = ("sync-symm", "sync-push", "async-symm", "async-push")


class RoundDraws(NamedTuple):
    """One round's random outcomes, in the reference's draw order."""

    active: torch.Tensor  # (N,) bool — participation (all True for the sync rounds)
    batch_idx: torch.Tensor  # (N, B, batch_size) int64 — local batch rows
    fading: Optional[torch.Tensor] = None  # (N, N) f32, channel on only


class BaselineState(NamedTuple):
    """The reference's fields, with ``key`` replaced by a
    `torch.Generator` and ``round_idx`` kept as a host int."""

    params: Dict[str, Any]  # {name: (N, ...)}
    push_weight: torch.Tensor  # (N,) push-sum weights (1.0 for the symm methods)
    round_idx: int
    generator: torch.Generator
    positions: torch.Tensor  # (N, 2) node coordinates (channel model)
    opt_state: Optional[torch.Tensor] = None  # (N, Dopt) f32 local optimizer plane


def init_baseline_state(key, cfg: DracoConfig, params0, task=None, *,
                        device=None) -> BaselineState:
    """params0: one client's param dict -> replicated across N clients.

    `key` is an int seed or a `torch.Generator`; it draws the node
    positions and then every round's draws. ``device=None`` means CUDA.
    `task` (a `Task`) sizes the optimizer plane; None or a bare loss
    gives (N, 0)."""
    g = as_generator(key, device)
    dev = g.device
    n = cfg.num_clients
    params = flat_lib.tree_map(
        lambda p: p.to(dev).unsqueeze(0).repeat((n,) + (1,) * p.dim()), params0)
    pos = channel_lib.place_nodes(g, n, cfg.channel or ChannelConfig())
    return BaselineState(params=params,
                         push_weight=torch.ones((n,), dtype=torch.float32, device=dev),
                         round_idx=0, generator=g, positions=pos,
                         opt_state=opt_plane(task, params0, n, dev))


def sample_round_draws(generator: torch.Generator, cfg: DracoConfig,
                       num_samples: int, p_active: Optional[float] = None,
                       compute_rate=None) -> RoundDraws:
    """Draw one round's `RoundDraws` from `generator`, on its device.
    `p_active` is the participation probability of the async rounds;
    None (the sync rounds) makes every client active without a draw,
    unless an (N,) `compute_rate` is given (then at probability 1,
    scaled). `num_samples` is the per-client shard size the batch rows
    index."""
    n, dev = cfg.num_clients, generator.device
    if p_active is None and compute_rate is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        active = _participation(generator, n, 1.0 if p_active is None else p_active,
                                compute_rate)
    batch_idx = torch.randint(0, num_samples, (n, cfg.local_batches, cfg.batch_size),
                              generator=generator, device=dev)
    fading = None
    if cfg.channel is not None and cfg.channel.enabled:
        fading = torch.empty((n, n), dtype=torch.float32,
                             device=dev).exponential_(generator=generator)
    return RoundDraws(active, batch_idx, fading)


def _link_success(state: BaselineState, cfg, adj, tx_mask, fading, positions=None):
    """This round's surviving directed links i -> j (N, N) bool, channel
    drops included; `positions` (N, 2), when given, replace the state's."""
    if cfg.channel is not None and cfg.channel.enabled:
        pos = state.positions if positions is None else positions
        _, success = channel_lib.transmission_delays(fading, pos, tx_mask, cfg.channel)
        return success & adj
    return adj & tx_mask[:, None]


def _participation(generator: torch.Generator, n: int, p_base: float,
                   compute_rate=None) -> torch.Tensor:
    """Per-client participation mask (N,) bool at probability `p_base`,
    scaled by a schedule's (N,) `compute_rate` and clipped into [0, 1]
    when one is given (stragglers show up less often)."""
    p = p_base if compute_rate is None else torch.clamp(p_base * compute_rate, 0.0, 1.0)
    return torch.rand((n,), generator=generator, device=generator.device) < p


def _mix_rows(w, params, mix: Optional[Callable] = None):
    """``out_i = sum_j w[i, j] p_j`` on the flat (N, Dflat) f32 plane:
    one ``mix(w.T, plane)`` (`gossip_mix`, the mix kernel on the card, by
    default), unraveled to the leaves' dtypes."""
    mix = gossip_ops.gossip_mix if mix is None else mix
    spec = flat_lib.spec_of(params)
    plane = flat_lib.ravel_clients(params)
    return flat_lib.unravel_clients(mix(w.T, plane), spec)


def _rows(mesh, n: int) -> slice:
    """This rank's clients of `n` (all of them off a mesh)."""
    return slice(0, n) if mesh is None else mesh.client_slice(n)


def _mixer(mix, mesh):
    """The round's mix function: `mix` when given; on a `mesh`,
    `launch.steps.mesh_mix`'s dense mode; else None (`gossip_mix`)."""
    if mix is not None or mesh is None:
        return mix
    from repro_torch.launch import steps

    return steps.mesh_mix(mesh, "dense")


def _local(state, cfg, task, data, draws, p_active, compute_rate, lr=None, mesh=None):
    """The round's draws, and its local step on the active clients (`lr`,
    when given, overriding ``cfg.lr``: a sweep row's), on the `mesh`
    rank's rows when one is given: ``(draws, params + Delta, opt_state)``."""
    if draws is None:
        draws = sample_round_draws(state.generator, cfg, data[0].shape[1], p_active,
                                   compute_rate)
    sl = _rows(mesh, cfg.num_clients)
    delta, opt_state = local_step(state.params, draws.active[sl], cfg, task, data,
                                  draws.batch_idx[sl], state.opt_state, state.round_idx,
                                  lr=lr)
    params = flat_lib.tree_map(lambda p, d: p + d.to(p.dtype), state.params, delta)
    return draws, params, opt_state


def push_split(succ: torch.Tensor) -> torch.Tensor:
    """sync-push's column-stochastic mass split (N, N) f32: row i splits
    sender i's mass evenly over itself and its surviving out-links."""
    col = succ.to(torch.float32) + torch.eye(succ.shape[0], device=succ.device)
    return col / col.sum(dim=1, keepdim=True)


def half_push_split(succ: torch.Tensor) -> torch.Tensor:
    """async-push's mass split (N, N) f32: a client with surviving
    out-links keeps half its mass and splits the other half evenly over
    them; one without keeps all of it."""
    out = succ.to(torch.float32)
    outdeg = out.sum(dim=1, keepdim=True)
    send = torch.where(outdeg > 0, 0.5 * out / torch.clamp(outdeg, min=1e-9), 0.0)
    return send + torch.diag(torch.where(outdeg[:, 0] > 0, 0.5, 1.0))


def _de_bias(params, push_weight):
    n = push_weight.shape[0]
    return flat_lib.tree_map(
        lambda p: (p.to(torch.float32) / push_weight.reshape((n,) + (1,) * (p.dim() - 1)))
        .to(p.dtype), params)


def _advance(state, params, opt_state, positions, push_weight=None):
    """End of round: positions track mobility, when a schedule moves them."""
    kw = dict(params=params, round_idx=state.round_idx + 1, opt_state=opt_state)
    if push_weight is not None:
        kw["push_weight"] = push_weight
    if positions is not None:
        kw["positions"] = positions
    return state._replace(**kw)


def sync_symm_round(state: BaselineState, cfg, w_sym, adj, task, data, *,
                    draws: Optional[RoundDraws] = None, mix=None, positions=None,
                    compute_rate=None, lr=None, mesh=None) -> BaselineState:
    """D-SGD with Metropolis weights `w_sym` (N, N); dropped links' mass
    folds into the self-loop. `task` is a `Task` or a bare batched loss;
    `draws` injects the round's `RoundDraws`; `mix` is the mix function
    (`gossip_ops.gossip_mix` when None). A schedule's `compute_rate`
    makes stragglers skip their local step (their params still mix);
    `positions` move the channel's nodes; `lr` overrides ``cfg.lr``;
    `mesh` runs the round on this rank's clients (see the module
    docstring). The same in every round function."""
    n = cfg.num_clients
    draws, params, opt_state = _local(state, cfg, task, data, draws, None, compute_rate, lr,
                                      mesh)
    all_on = torch.ones((n,), dtype=torch.bool, device=adj.device)
    succ = _link_success(state, cfg, adj, all_on, draws.fading, positions)
    succ = succ & succ.T  # symmetric methods need bidirectional links
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    w = torch.where(succ & ~eye, w_sym, 0.0)
    # dropped links' weight folds back into the self-loop (w stays row-stochastic)
    w = torch.where(eye, 1.0 - w.sum(dim=1, keepdim=True), w)
    return _advance(state, _mix_rows(w, params, _mixer(mix, mesh)), opt_state, positions)


def sync_push_round(state: BaselineState, cfg, adj, task, data, *,
                    draws: Optional[RoundDraws] = None, mix=None, positions=None,
                    compute_rate=None, lr=None, mesh=None):
    """Synchronous push-sum (stochastic gradient push, Assran et al.).
    Returns ``(state, de-biased params)``: on a `mesh` the rank's rows,
    the push weights N-wide."""
    n = cfg.num_clients
    draws, params, opt_state = _local(state, cfg, task, data, draws, None, compute_rate, lr,
                                      mesh)
    all_on = torch.ones((n,), dtype=torch.bool, device=adj.device)
    col_p = push_split(_link_success(state, cfg, adj, all_on, draws.fading, positions))
    params = _mix_rows(col_p.T, params, _mixer(mix, mesh))  # z_j = sum_i colP[i, j] z_i
    w = col_p.T @ state.push_weight
    return (_advance(state, params, opt_state, positions, w),
            _de_bias(params, w[_rows(mesh, n)]))


def async_symm_round(state: BaselineState, cfg, w_sym, adj, task, data,
                     p_active: float = 0.5, *, draws: Optional[RoundDraws] = None,
                     mix=None, positions=None, compute_rate=None,
                     lr=None, mesh=None) -> BaselineState:
    """Async decentralized SGD with a delay deadline: a random subset is
    active each round (probability `p_active`, scaled by a schedule's
    `compute_rate`); symmetric mixing among the surviving links between
    active clients."""
    n = cfg.num_clients
    draws, params, opt_state = _local(state, cfg, task, data, draws, p_active,
                                      compute_rate, lr, mesh)
    active = draws.active
    succ = _link_success(state, cfg, adj, active, draws.fading, positions)
    succ = succ & succ.T & active[:, None] & active[None, :]
    w = torch.where(succ, w_sym, 0.0)
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    w = torch.where(eye, 1.0 - w.sum(dim=1, keepdim=True), w)
    return _advance(state, _mix_rows(w, params, _mixer(mix, mesh)), opt_state, positions)


def async_push_round(state: BaselineState, cfg, adj, task, data,
                     p_active: float = 0.5, *, draws: Optional[RoundDraws] = None,
                     mix=None, positions=None, compute_rate=None, lr=None, mesh=None):
    """Asynchronous push-sum gossip (Digest-style): active clients push
    half their mass, split across their successful out-neighbours.
    Returns ``(state, de-biased params)``, as `sync_push_round` does."""
    draws, params, opt_state = _local(state, cfg, task, data, draws, p_active,
                                      compute_rate, lr, mesh)
    p = half_push_split(_link_success(state, cfg, adj, draws.active, draws.fading,
                                      positions))
    params = _mix_rows(p.T, params, _mixer(mix, mesh))
    w = p.T @ state.push_weight
    return (_advance(state, params, opt_state, positions, w),
            _de_bias(params, w[_rows(mesh, cfg.num_clients)]))


def baseline_round(method: str, state: BaselineState, cfg, w_sym, adj, task, data,
                   p_active: float = 0.5, *, draws: Optional[RoundDraws] = None,
                   mix=None, positions=None, compute_rate=None) -> BaselineState:
    """One round of `method` (one of `BASELINES`); returns the next state."""
    kw = dict(draws=draws, mix=mix, positions=positions, compute_rate=compute_rate)
    if method == "sync-symm":
        return sync_symm_round(state, cfg, w_sym, adj, task, data, **kw)
    if method == "sync-push":
        return sync_push_round(state, cfg, adj, task, data, **kw)[0]
    if method == "async-symm":
        return async_symm_round(state, cfg, w_sym, adj, task, data, p_active, **kw)
    if method == "async-push":
        return async_push_round(state, cfg, adj, task, data, p_active, **kw)[0]
    raise ValueError(method)


def run_baseline(method: str, state: BaselineState, cfg: DracoConfig, task, data,
                 num_rounds: int, *, graph_seed: Optional[int] = None,
                 draws_fn=None, mix=None, schedule=None) -> BaselineState:
    """`num_rounds` rounds of `method` in a Python loop (the reference
    scans). The graph and its Metropolis weights are built once on the
    state's device, or, with a `repro_torch.scenarios.Schedule`, taken
    with the positions and compute rates from ``schedule.at(round_idx)``
    each round; `draws_fn(round_idx)`, when given, injects each round's
    `RoundDraws`; `mix` as in the rounds."""
    pos = rate = None
    if schedule is None:
        adj = adjacency(cfg.topology, cfg.num_clients, seed=graph_seed,
                        device=state.push_weight.device)
        w_sym = metropolis(adj)
    for _ in range(num_rounds):
        if schedule is not None:
            v = schedule.at(state.round_idx)
            adj, w_sym, pos, rate = v.adj, v.w_sym, v.positions, v.compute_rate
        draws = None if draws_fn is None else draws_fn(state.round_idx)
        state = baseline_round(method, state, cfg, w_sym, adj, task, data, draws=draws,
                               mix=mix, positions=pos, compute_rate=rate)
    return state


def eval_params(method: str, state: BaselineState):
    """Method-appropriate evaluation params (the push methods de-bias)."""
    if method.endswith("push"):
        return _de_bias(state.params, state.push_weight)
    return state.params


def shard_state(state: BaselineState, rows: slice) -> BaselineState:
    """The client slice `rows` of a state, as a mesh round runs it (the
    round functions' `mesh`): copies of those rows of ``params`` and
    ``opt_state``; the push weights, positions, round index and generator
    as they are."""
    return protocol.shard_state(state, rows, {"opt_state": 0})


def gather_state(state: BaselineState, mesh) -> BaselineState:
    """Inverse of `shard_state` over a mesh: ``params`` and ``opt_state``
    gathered N-wide from the client ranks (on every rank)."""
    return protocol.gather_state(state, mesh, {"opt_state": 0})

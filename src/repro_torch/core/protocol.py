"""DRACO: the decentralized asynchronous protocol (Algorithm 1/2).

Port of the fused window engine of `repro.core.protocol`. One
`draco_window` is one superposition window (the paper's discretization
device, Sec. 2.2). In order, each window:

  1. drains the payload ring: every stored broadcast whose per-link
     delay equals its age arrives now, ``sum_j (Q_j ⊙ [delay_j ==
     age_j])^T @ buffer[slot_j]`` over the D-1 stored windows, oldest
     first, in one fused pass (`gossip_ops.gossip_drain`: the Hopper
     kernel on the card, the plain loop on the CPU);
  2. fires Poisson gradient events: B local SGD batches accumulate a
     pending update Delta;
  3. fires transmissions through the (optional) wireless channel under
     the Psi cap (Definition 1);
  4. enqueues this window's broadcast into ring slot ``widx % D``;
  5. every P windows, unifies on a rotating hub.

The state lives on the flat ``(N, Dflat)`` plane (`repro_torch.core.flat`).

Randomness. JAX's threefry and torch's Philox cannot give the same
draws, so a window's random outcomes are one `WindowDraws` record. By
default `draco_window` draws it from the state's `torch.Generator`;
tests inject the record the reference's key ladder produces.

Host syncs. ``window_idx`` is a Python int, so the drain slots and ages,
the enqueue slot and the unify decision are host arithmetic, as they are
static functions of the traced counter in JAX; nothing in a window reads
the device.

Deferred: the `Overrides`, scenario and legacy engines, and the local
optimizer plane (plain SGD only).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import as_generator, resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import flat as flat_lib
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.events import sample_event_masks
from repro_torch.core.topology import adjacency, row_stochastic
from repro_torch.kernels.gossip import ops as gossip_ops


@dataclass(frozen=True)
class DracoConfig:
    num_clients: int = 25
    lr: float = 0.05  # gamma
    local_batches: int = 1  # B
    batch_size: int = 64
    window: float = 1.0  # superposition window length (s)
    lambda_grad: float = 0.1  # Assumption 1 rate (paper default)
    lambda_tx: float = 0.1
    unify_period: int = 50  # P, in windows (0 = no unification)
    psi: int = 0  # max accepted msgs / client / period (0 = unbounded)
    topology: str = "cycle"
    max_delay_windows: int = 4  # ring buffer depth D (>= 2)
    apply_self_update: bool = False  # paper: senders do NOT apply own Delta
    channel: Optional[ChannelConfig] = None

    def __post_init__(self):
        if self.num_clients <= 0:
            raise ValueError(
                f"num_clients must be positive, got {self.num_clients}")
        if self.window <= 0:
            raise ValueError(f"window must be positive, got {self.window}")
        if self.max_delay_windows < 2:
            # the drain walks ages 1..D-1; D < 2 leaves no in-flight slot
            raise ValueError(
                "max_delay_windows must be >= 2 (depth-D ring holds D-1 "
                f"in-flight windows), got {self.max_delay_windows}")
        if self.psi < 0:
            raise ValueError(f"psi must be >= 0 (0 = unbounded), got {self.psi}")
        if self.unify_period < 0:
            raise ValueError(
                f"unify_period must be >= 0 (0 = never), got {self.unify_period}")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class WindowDraws(NamedTuple):
    """One window's random outcomes, in the reference's draw order."""

    grad_mask: torch.Tensor  # (N,) bool — gradient events
    batch_idx: torch.Tensor  # (N, B, batch_size) int64 — local batch rows
    tx_mask: torch.Tensor  # (N,) bool — transmission events
    fading: Optional[torch.Tensor] = None  # (N, N) f32, channel on only
    perm: Optional[torch.Tensor] = None  # (N,) int64 sender priority, psi > 0


class DracoState(NamedTuple):
    """Protocol state; the reference's fields, with ``key`` replaced by a
    `torch.Generator` and ``window_idx`` kept as a host int."""

    params: Dict[str, Any]  # {name: (N, ...)}
    pending: torch.Tensor  # (N, Dflat) f32 — accumulated untransmitted updates
    buffer: torch.Tensor  # (D, N, Dflat) f32 — raw broadcast payload ring
    w_ring: torch.Tensor  # (D, N, N) f32 — per-slot effective weights Q ⊙ accept
    delay_ring: torch.Tensor  # (D, N, N) int32 — per-slot per-link delays
    accept_count: torch.Tensor  # (N,) int32 — accepted this period
    total_accept: torch.Tensor  # (N,) int32 — accepted over the whole run
    window_idx: int
    generator: torch.Generator
    positions: torch.Tensor  # (N, 2) node coordinates (channel model)


def init_state(key, cfg: DracoConfig, params0, task=None, *,
               device=None) -> DracoState:
    """params0: one client's param dict -> replicated across N clients.

    `key` is an int seed or a `torch.Generator`; it draws the node
    positions and then every window's draws. ``device=None`` means CUDA.
    `task` is accepted for the reference's signature: with plain SGD
    there is no optimizer plane to size."""
    del task
    g = as_generator(key, device)
    dev = g.device
    n, d = cfg.num_clients, cfg.max_delay_windows
    params = flat_lib.tree_map(
        lambda p: p.to(dev).unsqueeze(0).repeat((n,) + (1,) * p.dim()), params0)
    spec = flat_lib.spec_of(params)
    pos = channel_lib.place_nodes(g, n, cfg.channel or ChannelConfig())
    return DracoState(
        params=params,
        pending=torch.zeros((n, spec.dim), dtype=torch.float32, device=dev),
        buffer=torch.zeros((d, n, spec.dim), dtype=torch.float32, device=dev),
        w_ring=torch.zeros((d, n, n), dtype=torch.float32, device=dev),
        delay_ring=torch.zeros((d, n, n), dtype=torch.int32, device=dev),
        accept_count=torch.zeros((n,), dtype=torch.int32, device=dev),
        total_accept=torch.zeros((n,), dtype=torch.int32, device=dev),
        window_idx=0,
        generator=g,
        positions=pos,
    )


def sample_window_draws(generator: torch.Generator, cfg: DracoConfig,
                        num_samples: int) -> WindowDraws:
    """Draw one window's `WindowDraws` from `generator`, on its device.

    `num_samples` is the per-client shard size the batch rows index."""
    n, dev = cfg.num_clients, generator.device
    grad_mask = sample_event_masks(generator, cfg.lambda_grad, cfg.window, n)
    batch_idx = torch.randint(
        0, num_samples, (n, cfg.local_batches, cfg.batch_size),
        generator=generator, device=dev)
    tx_mask = sample_event_masks(generator, cfg.lambda_tx, cfg.window, n)
    fading = perm = None
    if cfg.channel is not None and cfg.channel.enabled:
        fading = torch.empty((n, n), dtype=torch.float32,
                             device=dev).exponential_(generator=generator)
    if cfg.psi > 0:
        # argsort of uniform keys: a uniform permutation drawn on the device
        perm = torch.argsort(torch.rand((n,), generator=generator, device=dev))
    return WindowDraws(grad_mask, batch_idx, tx_mask, fading, perm)


def _sgd_step(task, lr) -> Callable:
    if task is not None and hasattr(task, "make_optimizer"):
        return task.make_optimizer(lr)
    return lambda p, g: p - lr * g


def local_updates(params, grad_mask, cfg: DracoConfig, task, data, batch_idx):
    """Per-client B-batch local SGD; returns the Delta dict (N, ...).

    All N clients run in one batched forward per local batch. `task` is
    a `Task` or a bare batched loss ``loss(params (N,...), x (N,b,...),
    y (N,b)) -> (N,)``; the gradient of the summed per-client losses is
    exactly each client's gradient of its own batch mean. `batch_idx`
    (N, B, batch_size) picks the rows of each client's shard. Clients
    outside `grad_mask` get a zero Delta, as in the reference."""
    xs, ys = data
    loss_fn = task.loss_fn if hasattr(task, "loss_fn") else task
    step = _sgd_step(task, cfg.lr)
    items = flat_lib.tree_items(params)
    paths = [path for path, _ in items]
    cur = [leaf for _, leaf in items]
    for b in range(cfg.local_batches):
        idx = batch_idx[:, b].long()
        x = torch.take_along_dim(xs, idx.reshape(idx.shape + (1,) * (xs.dim() - 2)),
                                 dim=1)
        y = torch.take_along_dim(ys, idx, dim=1)
        leaves = [leaf.detach().requires_grad_(True) for leaf in cur]
        with torch.enable_grad():
            loss = loss_fn(flat_lib.tree_from_items(zip(paths, leaves)), x, y)
            grads = torch.autograd.grad(loss.sum(), leaves)
        cur = [step(leaf.detach(), g) for leaf, g in zip(leaves, grads)]
    gm = grad_mask.to(torch.float32)
    return flat_lib.tree_from_items(
        (path, (new - old) * gm.reshape((-1,) + (1,) * (old.dim() - 1)))
        for path, new, (_, old) in zip(paths, cur, items))


def local_step(params, grad_mask, cfg: DracoConfig, task, data, batch_idx):
    """Local updates by workload representation (the reference's
    `local_step`): a bare batched loss or a `Task` with plain SGD runs
    `local_updates`; a `Task` with another optimizer raises
    `NotImplementedError` (its `make_optimizer`; ROADMAP.md queue 1 item
    8), since the port has no optimizer plane yet. Returns the Delta dict
    (N, ...)."""
    return local_updates(params, grad_mask, cfg, task, data, batch_idx)


def _psi_accept(success, accept_count, psi: int, perm):
    """Per-(sender, receiver) acceptance under the Psi cap.

    Senders take priority in the order `perm`; receiver j accepts while
    its period count + rank < psi. psi <= 0 is unbounded and uses no
    permutation. Returns (accept mask (N,N), new accept_count)."""
    arrivals = success.to(torch.int32)
    if psi <= 0:
        return success, accept_count + arrivals.sum(dim=0, dtype=torch.int32)
    inv = torch.argsort(perm)
    s_perm = arrivals[perm]  # senders reordered by priority
    rank = torch.cumsum(s_perm, dim=0, dtype=torch.int32) - s_perm
    ok_perm = (rank + accept_count[None, :] < psi) & (s_perm > 0)
    ok = ok_perm[inv]
    new_count = accept_count + ok.sum(dim=0, dtype=torch.int32)
    return ok & success, new_count


def quantize_delays(gamma, window: float, max_delay_windows: int):
    """Per-link delay in windows + deliverability mask.

    ``delay_w = clip(ceil(gamma / window), 1, D-1)``; a link whose raw
    delay exceeds D-1 cannot be delivered at its true age, so it is
    dropped (still clipped in ``delay_w``). Returns (delay_w (N,N) int32,
    deliverable (N,N) bool).

    Compared and clipped in float before the int cast: XLA saturates an
    out-of-range float -> int32 cast, torch wraps it to INT_MIN, which
    would turn a huge delay into a deliverable one-window delay."""
    raw = torch.ceil(gamma / window)
    deliverable = raw <= max_delay_windows - 1
    delay_w = torch.clamp(raw, 1, max_delay_windows - 1).to(torch.int32)
    return delay_w, deliverable


def _tx_and_accept(state, cfg, q, adj, draws: WindowDraws):
    """Transmissions + channel + Psi cap. Returns (tx_mask (N,), w_eff
    (N,N), delay_w (N,N) int32, accept_count, total_accept)."""
    n, D = cfg.num_clients, cfg.max_delay_windows
    tx_mask = draws.tx_mask
    if cfg.channel is not None and cfg.channel.enabled:
        gamma, success = channel_lib.transmission_delays(
            draws.fading, state.positions, tx_mask, cfg.channel)
        delay_w, deliverable = quantize_delays(gamma, cfg.window, D)
        success = success & deliverable & adj
    else:
        success = adj & tx_mask[:, None]
        delay_w = torch.ones((n, n), dtype=torch.int32, device=q.device)
    accept, accept_count = _psi_accept(success, state.accept_count, cfg.psi,
                                       draws.perm)
    # the cumulative counter survives the periodic accept_count reset
    total_accept = state.total_accept + (accept_count - state.accept_count)
    w_eff = q * accept.to(q.dtype)  # (sender, receiver)
    return tx_mask, w_eff, delay_w, accept_count, total_accept


def _unify(params, accept_count, widx: int, cfg, n: int):
    """Every P windows (at ``(widx + 1) % P == 0``) every client adopts
    hub ``(widx // P) % n``'s params and accept counts reset. Pending
    updates, the ring and total_accept are left alone."""
    if (widx + 1) % cfg.unify_period != 0:
        return params, accept_count
    hub = (widx // max(cfg.unify_period, 1)) % n
    params = flat_lib.tree_map(lambda x: x[hub].expand_as(x).clone(), params)
    return params, torch.zeros_like(accept_count)


def draco_window(state: DracoState, cfg: DracoConfig, q, adj, task, data,
                 spec=None, *, draws: Optional[WindowDraws] = None,
                 damping=None, drain=None) -> DracoState:
    """One superposition window; returns the next state.

    `q` (N, N) is the row-stochastic mixing matrix, `adj` (N, N) its
    boolean adjacency; `task` a `Task` or a bare batched loss; `data`
    the ``(xs (N, S, ...), ys (N, S))`` shards; `spec` the `FlatSpec`
    (derived from ``state.params`` when omitted).

    `draws` injects this window's `WindowDraws`; None draws them from
    ``state.generator``. `damping` is an optional age-indexed ``(D,)``
    f32 vector scaling the bucket of messages ``j`` windows old by
    ``damping[j]`` (the staleness hook). `drain` is the drain function,
    `gossip_ops.gossip_drain` when None; ``chip_smoke.py`` passes the
    plain version to hold the path against it.

    The enqueue writes ``state.buffer``, ``w_ring`` and ``delay_ring``
    in place (the returned state shares them), so a state is consumed by
    the window that advances it.
    """
    n, D = cfg.num_clients, cfg.max_delay_windows
    widx = state.window_idx
    if spec is None:
        spec = flat_lib.spec_of(state.params)
    if draws is None:
        draws = sample_window_draws(state.generator, cfg, data[0].shape[1])
    drain = gossip_ops.gossip_drain if drain is None else drain

    # --- 1. deliveries: fused delay-bucketed drain on the flat plane -------
    # the broadcast of age a (sent in window widx - a) arrives now iff its
    # per-link delay equals a; oldest first, as the reference accumulates
    ages = range(D - 1, 0, -1)
    slots = [(widx - a) % D for a in ages]
    buckets = []
    for s, a in zip(slots, ages):
        w = state.w_ring[s] * (state.delay_ring[s] == a).to(state.w_ring.dtype)
        buckets.append(w if damping is None else w * damping[a])
    arrivals_flat = drain(torch.stack(buckets), state.buffer, slots)
    arrivals = flat_lib.unravel_clients(arrivals_flat, spec)
    params = flat_lib.tree_map(lambda p, a: p + a.to(p.dtype), state.params,
                               arrivals)

    # --- 2. gradient events ------------------------------------------------
    delta = local_step(params, draws.grad_mask, cfg, task, data,
                       draws.batch_idx)
    pending = state.pending + flat_lib.ravel_clients(delta)
    if cfg.apply_self_update:
        params = flat_lib.tree_map(lambda p, dl: p + dl.to(p.dtype), params,
                                   delta)

    # --- 3. transmission events + channel ----------------------------------
    tx_mask, w_eff, delay_w, accept_count, total_accept = _tx_and_accept(
        state, cfg, q, adj, draws)

    # enqueue in place. Safe: this window's drain read slots (widx - a) % D
    # for a in 1..D-1, which never include widx % D, and the broadcast that
    # slot held (window widx - D) is older than any drain reads. The ring
    # takes a copy of `pending`, never a view, so clearing it below leaves
    # the stored broadcast intact.
    slot = widx % D
    state.buffer[slot].copy_(pending)
    state.w_ring[slot].copy_(w_eff)
    state.delay_ring[slot].copy_(delay_w)

    # senders clear their pending backlog (Lemma A.1 backups are now sent)
    pending.mul_((~tx_mask).to(torch.float32)[:, None])

    # --- 4. periodic unification -------------------------------------------
    if cfg.unify_period > 0:
        params, accept_count = _unify(params, accept_count, widx, cfg, n)

    return state._replace(params=params, pending=pending,
                          accept_count=accept_count, total_accept=total_accept,
                          window_idx=widx + 1)


def run_windows(state: DracoState, cfg: DracoConfig, q, adj, task, data,
                num_windows: int, *, draws_fn=None, drain=None) -> DracoState:
    """`num_windows` windows in a Python loop (the reference scans).

    `q` (N, N) row-stochastic weights; `draws_fn(window_idx)`, when
    given, injects each window's `WindowDraws`; `drain` as in
    `draco_window`."""
    spec = flat_lib.spec_of(state.params)
    for _ in range(num_windows):
        draws = None if draws_fn is None else draws_fn(state.window_idx)
        state = draco_window(state, cfg, q, adj, task, data, spec,
                             draws=draws, drain=drain)
    return state


def build_graph(cfg: DracoConfig, seed: Optional[int] = None, *, device=None):
    """``(q (N, N) f32, adj (N, N) bool)`` for ``cfg.topology`` on
    `device` (None means CUDA); `seed` seeds random topologies."""
    dev = resolve_device(device)
    adj = adjacency(cfg.topology, cfg.num_clients, seed=seed, device=dev)
    return row_stochastic(adj), adj


def virtual_global_model(params):
    """x_bar = E_i[x^(i)] (Sec. 2.1) — evaluation only."""
    return flat_lib.tree_map(lambda p: p.mean(dim=0), params)

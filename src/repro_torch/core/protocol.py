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

Workloads. A bare batched loss runs plain SGD (`local_updates`); a
`Task` runs its own local optimizer (`task_local_updates`), whose state
is the client-local ``(N, Dopt)`` f32 plane ``DracoState.opt_state``:
never gossiped, and left alone by hub unification.

Scenarios. `draco_window` takes a schedule's step-t ``positions``,
``compute_rate`` and ``tx_rate`` (`repro_torch.scenarios`): the positions
replace the state's for the channel (and are carried on), the rates
scale each client's Poisson grad and transmission rates.

Sweeps. `Overrides` re-binds the sweepable fields (lr, lambda_grad,
lambda_tx, psi) for one row of a config grid (`repro_torch.api.sweep`).
Rows run one after another on the host, so an override is a Python
number and a row equals the solo run with ``cfg.replace(field=value)``
exactly. The seed axis: `stack_seeds` stacks R solo states (each from
its own seed's `init_state`) into one whose tensors carry a leading R
axis and whose generator is the R generators; `draco_window` advances
such a state in one pass, the drain in one launch for all seeds
(`gossip_ops.gossip_drain`'s seed axis), each seed drawing from its own
generator exactly as its solo run does. `seed_row` views seed r.

The legacy engine. `DracoStateLegacy`, `init_state_legacy`,
`draco_window_legacy` and `run_windows_legacy` port the reference's
pre-fusion engine: per-leaf rings of already-mixed deltas, D-1 separate
per-bucket contractions at enqueue time, no flat plane and no drain. It
is the oracle of the fused window and the baseline of
``benchmarks/torch_run.py``'s ``draco_window`` bench; it takes the same
`WindowDraws` as `draco_window`, so one record drives both engines.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import as_generator, resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import flat as flat_lib
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.events import sample_event_masks
from repro_torch.core.topology import adjacency, row_stochastic
from repro_torch.kernels.gossip import ops as gossip_ops
from repro_torch.optim import apply_updates
from repro_torch.tasks.base import is_task, opt_layout, opt_width


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


class Overrides(NamedTuple):
    """Per-row re-bindings of sweepable `DracoConfig` fields.

    The sweep engine (`repro_torch.api.sweep`) sets one per grid row;
    None fields keep the config's value, so an all-None `Overrides` is
    the plain config path. Values are Python numbers: rows run one after
    another on the host, so the lr stays a host f32 (the schedules'
    numpy arithmetic) and psi a host int. `psi` follows the config
    convention: values <= 0 mean unbounded reception."""

    lr: Optional[float] = None
    lambda_grad: Optional[float] = None
    lambda_tx: Optional[float] = None
    psi: Optional[int] = None


def rebound(cfg, overrides: Optional[Overrides], name: str):
    """``cfg.<name>``, or the override's value when it sets one."""
    value = None if overrides is None else getattr(overrides, name)
    return getattr(cfg, name) if value is None else value


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
    opt_state: Optional[torch.Tensor] = None  # (N, Dopt) f32 local optimizer plane


def opt_plane(task, params0, n: int, device) -> torch.Tensor:
    """Zero (N, Dopt) f32 optimizer plane for `task` (Dopt = 0 for a bare
    loss or plain SGD: an empty column block)."""
    return torch.zeros((n, opt_width(task, params0)), dtype=torch.float32,
                       device=device)


def init_state(key, cfg: DracoConfig, params0, task=None, *,
               device=None) -> DracoState:
    """params0: one client's param dict -> replicated across N clients.

    `key` is an int seed or a `torch.Generator`; it draws the node
    positions and then every window's draws. ``device=None`` means CUDA.
    `task` (a `Task`) sizes the optimizer plane ``opt_state`` (momentum
    Dflat, adamw 2 * Dflat + 1); None or a bare loss gives (N, 0)."""
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
        opt_state=opt_plane(task, params0, n, dev),
    )


def _scaled(lam: float, rate: Optional[torch.Tensor]):
    """A config rate, scaled per client by a schedule's (N,) ring row."""
    return lam if rate is None else lam * rate


def sample_window_draws(generator, cfg: DracoConfig, num_samples: int,
                        compute_rate=None, tx_rate=None,
                        overrides: Optional[Overrides] = None) -> WindowDraws:
    """Draw one window's `WindowDraws` from `generator`, on its device.

    `num_samples` is the per-client shard size the batch rows index; the
    (N,) `compute_rate` and `tx_rate`, when given, scale lambda_grad and
    lambda_tx per client; `overrides` re-binds lambda_grad, lambda_tx and
    psi (a permutation is drawn only under a cap, psi > 0). A tuple of R
    generators (a seed-stacked state's) gives each seed's draws, drawn as
    its solo run draws them, stacked on a leading R axis."""
    if isinstance(generator, tuple):
        return stack_draws([sample_window_draws(g, cfg, num_samples, compute_rate,
                                                tx_rate, overrides) for g in generator])
    n, dev = cfg.num_clients, generator.device
    grad_mask = sample_event_masks(
        generator, _scaled(rebound(cfg, overrides, "lambda_grad"), compute_rate),
        cfg.window, n)
    batch_idx = torch.randint(
        0, num_samples, (n, cfg.local_batches, cfg.batch_size),
        generator=generator, device=dev)
    tx_mask = sample_event_masks(
        generator, _scaled(rebound(cfg, overrides, "lambda_tx"), tx_rate), cfg.window, n)
    fading = perm = None
    if cfg.channel is not None and cfg.channel.enabled:
        fading = torch.empty((n, n), dtype=torch.float32,
                             device=dev).exponential_(generator=generator)
    # repro-lint: disable-next-line=TRACED-PY-BRANCH(an Overrides holds Python numbers re-bound per sweep row on the host, never tensors: psi is a host int)
    if rebound(cfg, overrides, "psi") > 0:
        # argsort of uniform keys: a uniform permutation drawn on the device
        perm = torch.argsort(torch.rand((n,), generator=generator, device=dev))
    return WindowDraws(grad_mask, batch_idx, tx_mask, fading, perm)


def stack_draws(draws):
    """R seeds' draws records (`WindowDraws`, or any named tuple of
    tensors and Nones) -> one with a leading R axis on each field."""
    return type(draws[0])(*(None if f[0] is None else torch.stack(f) for f in zip(*draws)))


def _batch(xs, ys, idx):
    """Rows `idx` (L, b) of each client's shard: ``x (L, b, ...)`` and
    ``y (L, b, ...)``, any trailing axes of either kept (tiny-lm's
    targets are (N, S_shard, seq)). Row i reads client ``i % N``'s shard,
    so a seed-stacked step's R * N rows read the N shards R times over."""
    if idx.shape[0] != xs.shape[0]:
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None] % xs.shape[0]
        return xs[rows, idx], ys[rows, idx]

    def take(a):
        return torch.take_along_dim(
            a, idx.reshape(tuple(idx.shape) + (1,) * (a.dim() - 2)), dim=1)

    return take(xs), take(ys)


def _grads(loss_fn, paths, leaves, x, y):
    """Per-client gradients of a batched loss: one forward of all N
    clients, the gradient of the summed (N,) losses."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with torch.enable_grad():
        loss = loss_fn(flat_lib.tree_from_items(zip(paths, leaves)), x, y)
        return torch.autograd.grad(loss.sum(), leaves)


def _masked_delta(new, old, grad_mask):
    gm = grad_mask.to(torch.float32)
    return flat_lib.tree_map(
        lambda a, b: (a - b) * gm.reshape((-1,) + (1,) * (b.dim() - 1)), new, old)


def local_updates(params, grad_mask, cfg: DracoConfig, task, data, batch_idx, *,
                  lr=None):
    """Per-client B-batch local SGD (``p - lr * g``) of a bare batched
    loss; returns the Delta dict (N, ...).

    All N clients run in one batched forward per local batch. `task` is
    a bare batched loss ``loss(params (N,...), x (N,b,...), y (N,b,...))
    -> (N,)`` (or a `Task`, whose loss runs under plain SGD); the
    gradient of the summed per-client losses is exactly each client's
    gradient of its own batch mean. `batch_idx` (N, B, batch_size) picks
    the rows of each client's shard. Clients outside `grad_mask` get a
    zero Delta, as in the reference. `lr`, when given, overrides
    ``cfg.lr`` (a sweep row's)."""
    xs, ys = data
    lr = cfg.lr if lr is None else lr
    loss_fn = task.loss_fn if hasattr(task, "loss_fn") else task
    items = flat_lib.tree_items(params)
    paths = [path for path, _ in items]
    cur = [leaf for _, leaf in items]
    for b in range(cfg.local_batches):
        x, y = _batch(xs, ys, batch_idx[:, b].long())
        grads = _grads(loss_fn, paths, cur, x, y)
        cur = [leaf - lr * g for leaf, g in zip(cur, grads)]
    return _masked_delta(flat_lib.tree_from_items(zip(paths, cur)), params, grad_mask)


@lru_cache(maxsize=None)
def _opt_spec(task, spec: flat_lib.FlatSpec) -> flat_lib.FlatSpec:
    """Client-stacked layout of `task`'s optimizer state for parameters
    laid out as `spec` (host work, once per task and layout)."""
    single = flat_lib.tree_from_items(
        (path, torch.empty(shape[1:], dtype=dt, device="meta"))
        for path, shape, dt in zip(spec.paths, spec.shapes, spec.dtypes))
    layout = opt_layout(task, single)
    return layout._replace(
        shapes=tuple((spec.num_clients,) + s[1:] for s in layout.shapes))


def task_local_updates(params, grad_mask, cfg: DracoConfig, task, data,
                       batch_idx, opt_state, step: int, *, lr=None):
    """Per-client B-batch local updates through the task's optimizer.

    Each local batch computes every client's gradient in one batched
    forward and feeds it to the task's `repro_torch.optim` rule. The
    optimizer state lives on the flat plane: `opt_state` (N, Dopt) f32 is
    viewed as the optimizer's state dict (exact reshape) and raveled
    back. Clients outside `grad_mask` fired no gradient event: their
    Delta is zero and their `opt_state` row is kept as it was, bit for
    bit. `step` (the host-int window or round index) feeds the lr
    schedule, shared by the B batches; `lr`, when given, overrides
    ``cfg.lr`` in the rebuilt optimizer (a sweep row's). Returns ``(Delta
    dict (N, ...), new opt_state (N, Dopt))``."""
    xs, ys = data
    opt = task.make_optimizer(cfg.lr if lr is None else lr)
    # a plane of another width than the task's `opt_width` fails to reshape
    state = flat_lib.unravel_clients(opt_state, _opt_spec(task, flat_lib.spec_of(params)))
    paths = [path for path, _ in flat_lib.tree_items(params)]
    cur = params
    for b in range(cfg.local_batches):
        x, y = _batch(xs, ys, batch_idx[:, b].long())
        grads = _grads(task.loss_fn, paths, flat_lib.tree_leaves(cur), x, y)
        upd, state = opt.update(flat_lib.tree_from_items(zip(paths, grads)), state,
                                cur, step)
        cur = apply_updates(cur, upd)
    if opt_state.shape[1]:  # plain SGD keeps no state
        opt_state = torch.where(grad_mask[:, None], flat_lib.ravel_clients(state),
                                opt_state)
    return _masked_delta(cur, params, grad_mask), opt_state


def local_step(params, grad_mask, cfg: DracoConfig, task, data, batch_idx,
               opt_state=None, step: int = 0, *, lr=None):
    """Local updates by workload representation (the reference's
    `local_step`): a bare batched loss (or None) runs `local_updates`
    and passes `opt_state` (N, Dopt) through untouched; a `Task` runs
    `task_local_updates` with its optimizer. `lr` overrides ``cfg.lr``.
    Returns ``(Delta dict (N, ...), opt_state)``."""
    if not is_task(task):
        return (local_updates(params, grad_mask, cfg, task, data, batch_idx, lr=lr),
                opt_state)
    return task_local_updates(params, grad_mask, cfg, task, data, batch_idx,
                              opt_state, step, lr=lr)


def _psi_accept(success, accept_count, psi: int, perm):
    """Per-(sender, receiver) acceptance under the Psi cap.

    Senders take priority in the order `perm`; receiver j accepts while
    its period count + rank < psi. psi <= 0 is unbounded and uses no
    permutation. Returns (accept mask (N,N), new accept_count). Leading
    seed axes ride along: success (..., N, N), accept_count and perm
    (..., N)."""
    arrivals = success.to(torch.int32)
    if psi <= 0:
        return success, accept_count + arrivals.sum(dim=-2, dtype=torch.int32)
    perm = perm.long()
    inv = torch.argsort(perm, dim=-1)
    # senders reordered by priority
    s_perm = torch.take_along_dim(arrivals, perm[..., :, None], dim=-2)
    rank = torch.cumsum(s_perm, dim=-2, dtype=torch.int32) - s_perm
    ok_perm = (rank + accept_count[..., None, :] < psi) & (s_perm > 0)
    ok = torch.take_along_dim(ok_perm, inv[..., :, None], dim=-2)
    new_count = accept_count + ok.sum(dim=-2, dtype=torch.int32)
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


def _tx_and_accept(state, cfg, q, adj, draws: WindowDraws, positions=None, psi=None):
    """Transmissions + channel + Psi cap; `positions` (N, 2), when given,
    replace the state's for the channel; `psi` overrides ``cfg.psi``.
    Returns (tx_mask (N,), w_eff (N,N), delay_w (N,N) int32,
    accept_count, total_accept), with a seed-stacked state's leading R
    axis."""
    n, D = cfg.num_clients, cfg.max_delay_windows
    tx_mask = draws.tx_mask
    if cfg.channel is not None and cfg.channel.enabled:
        pos = state.positions if positions is None else positions
        gamma, success = channel_lib.transmission_delays(
            draws.fading, pos, tx_mask, cfg.channel)
        delay_w, deliverable = quantize_delays(gamma, cfg.window, D)
        success = success & deliverable & adj
    else:
        success = adj & tx_mask[..., :, None]
        delay_w = torch.ones((n, n), dtype=torch.int32, device=q.device)
    accept, accept_count = _psi_accept(success, state.accept_count,
                                       cfg.psi if psi is None else psi, draws.perm)
    # the cumulative counter survives the periodic accept_count reset
    total_accept = state.total_accept + (accept_count - state.accept_count)
    w_eff = q * accept.to(q.dtype)  # (sender, receiver)
    return tx_mask, w_eff, delay_w, accept_count, total_accept


def _unify(params, accept_count, widx: int, cfg, n: int, seeds: int = 0, mesh=None):
    """Every P windows (at ``(widx + 1) % P == 0``) every client adopts
    hub ``(widx // P) % n``'s params and accept counts reset. Pending
    updates, the ring and total_accept are left alone. `seeds` is the
    number of leading seed axes of the params (0 or 1): each seed adopts
    its own hub row. On a `mesh` the params hold this rank's clients: the
    rank holding the hub broadcasts its row (every leaf in one buffer)."""
    if (widx + 1) % cfg.unify_period != 0:
        return params, accept_count
    hub = (widx // max(cfg.unify_period, 1)) % n
    leaves = flat_lib.tree_leaves(params)
    if mesh is None:
        rows = [x.select(seeds, hub) for x in leaves]
    else:
        src = mesh.owner(hub, n)
        local = hub - src * (n // mesh.size) if src == mesh.rank else 0
        rows = mesh.broadcast_tensors([x.select(seeds, local) for x in leaves], src)
    params = flat_lib.tree_from_items(
        (path, row.unsqueeze(seeds).expand_as(x).clone())
        for (path, x), row in zip(flat_lib.tree_items(params), rows))
    return params, torch.zeros_like(accept_count)


def draco_window(state: DracoState, cfg: DracoConfig, q, adj, task, data,
                 spec=None, *, draws: Optional[WindowDraws] = None,
                 positions=None, compute_rate=None, tx_rate=None,
                 overrides: Optional[Overrides] = None, damping=None,
                 drain=None, mesh=None) -> DracoState:
    """One superposition window; returns the next state.

    `q` (N, N) is the row-stochastic mixing matrix, `adj` (N, N) its
    boolean adjacency; `task` a `Task` (its optimizer's state on
    ``state.opt_state`` (N, Dopt)) or a bare batched loss; `data` the
    ``(xs (N, S, ...), ys (N, S, ...))`` shards; `spec` the per-client
    `FlatSpec` (derived from ``state.params`` when omitted).

    A scenario schedule's step-t snapshot comes in the keyword trio:
    `positions` (N, 2) replace the state's node coordinates for this
    window's channel and are carried on in the returned state;
    `compute_rate` and `tx_rate` (N,) scale lambda_grad and lambda_tx
    per client. None for all three is the frozen path. `overrides`
    re-binds lr, lambda_grad, lambda_tx and psi for a sweep row.

    A seed-stacked state (`stack_seeds`: leading R axis, R generators)
    runs all R seeds in one pass: the drain in one launch of the seed
    axis, the local step over the R * N client rows, the channel, Psi
    and unification on the stacked tensors; each seed's draws come from
    its own generator as in its solo run (``draws`` then carries the R
    axis too).

    `draws` injects this window's `WindowDraws`; None draws them from
    ``state.generator``. `damping` is an optional age-indexed ``(D,)``
    f32 vector scaling the bucket of messages ``j`` windows old by
    ``damping[j]`` (the staleness hook). `drain` is the drain function,
    `gossip_ops.gossip_drain` when None; ``chip_smoke.py`` passes the
    plain version to hold the path against it.

    `mesh` (a `repro_torch.launch.mesh.Mesh`) runs the window on a client
    slice, ``mesh.client_slice(N)``: the state holds this rank's rows
    (`shard_state`) of params, pending, the payload ring, opt_state, and
    of the sender axis of ``w_ring`` and ``delay_ring`` (its senders
    against all N receivers); accept counts and positions stay N-wide.
    The draws, the channel and Psi are computed N-wide on every rank from
    the same generator, so every rank takes the same decisions; `data`
    holds the rank's shards; the drain is `gossip_drain_sharded` (each
    rank's rectangular drain, one reduce-scatter) unless `drain` is
    given; unification is a broadcast from the hub's rank.

    The enqueue writes ``state.buffer``, ``w_ring`` and ``delay_ring``
    in place (the returned state shares them), so a state is consumed by
    the window that advances it.
    """
    n, D = cfg.num_clients, cfg.max_delay_windows
    widx = state.window_idx
    lead = tuple(state.pending.shape[:-2])  # () or the seed axis (R,)
    sl = slice(0, n) if mesh is None else mesh.client_slice(n)  # this rank's clients
    if spec is None:
        spec = flat_lib.spec_of(state.params if not lead else seed_row(state, 0).params)
    if draws is None:
        draws = sample_window_draws(state.generator, cfg, data[0].shape[1],
                                    compute_rate, tx_rate, overrides)
    if drain is None and mesh is not None:
        from repro_torch.launch import mesh as mesh_lib

        def drain(w, ring, slots):
            return gossip_ops.gossip_drain_sharded(w, ring, slots, mesh,
                                                   mesh_lib.client_axes(mesh))
    drain = gossip_ops.gossip_drain if drain is None else drain

    # --- 1. deliveries: fused delay-bucketed drain on the flat plane -------
    # the broadcast of age a (sent in window widx - a) arrives now iff its
    # per-link delay equals a; oldest first, as the reference accumulates
    ages = range(D - 1, 0, -1)
    slots = [(widx - a) % D for a in ages]
    buckets = []
    for s, a in zip(slots, ages):
        w = state.w_ring[..., s, :, :] * (state.delay_ring[..., s, :, :] == a).to(
            state.w_ring.dtype)
        buckets.append(w if damping is None else w * damping[a])
    arrivals_flat = drain(torch.stack(buckets, dim=-3), state.buffer, slots)
    arrivals = flat_lib.unravel_clients(arrivals_flat, spec)
    params = flat_lib.tree_map(lambda p, a: p + a.to(p.dtype), state.params,
                               arrivals)

    # --- 2. gradient events: the R * N client rows in one pass -------------
    rows = math.prod(lead) * (sl.stop - sl.start)
    delta, opt_state = local_step(
        flat_lib.tree_map(lambda p: p.reshape((rows,) + tuple(p.shape[len(lead) + 1:])),
                          params),
        draws.grad_mask[..., sl].reshape(rows), cfg, task, data,
        draws.batch_idx[..., sl, :, :].reshape((rows,) + tuple(draws.batch_idx.shape[-2:])),
        state.opt_state.reshape(rows, state.opt_state.shape[-1]), widx,
        lr=rebound(cfg, overrides, "lr"))
    pending = state.pending + flat_lib.ravel_clients(delta).reshape(state.pending.shape)
    opt_state = opt_state.reshape(state.opt_state.shape)
    if cfg.apply_self_update:
        params = flat_lib.tree_map(lambda p, dl: p + dl.reshape(p.shape).to(p.dtype),
                                   params, delta)

    # --- 3. transmission events + channel ----------------------------------
    tx_mask, w_eff, delay_w, accept_count, total_accept = _tx_and_accept(
        state, cfg, q, adj, draws, positions, rebound(cfg, overrides, "psi"))

    # enqueue in place. Safe: this window's drain read slots (widx - a) % D
    # for a in 1..D-1, which never include widx % D, and the broadcast that
    # slot held (window widx - D) is older than any drain reads. The ring
    # takes a copy of `pending`, never a view, so clearing it below leaves
    # the stored broadcast intact.
    slot = widx % D
    state.buffer[..., slot, :, :].copy_(pending)
    state.w_ring[..., slot, :, :].copy_(w_eff[..., sl, :])
    state.delay_ring[..., slot, :, :].copy_(delay_w[..., sl, :])

    # senders clear their pending backlog (Lemma A.1 backups are now sent)
    pending.mul_((~tx_mask[..., sl]).to(torch.float32)[..., None])

    # --- 4. periodic unification -------------------------------------------
    if cfg.unify_period > 0:
        params, accept_count = _unify(params, accept_count, widx, cfg, n, len(lead), mesh)

    if positions is not None and lead:
        positions = positions.expand(lead + tuple(positions.shape))
    return state._replace(
        params=params, pending=pending, accept_count=accept_count,
        total_accept=total_accept, window_idx=widx + 1,
        positions=state.positions if positions is None else positions,
        opt_state=opt_state)


def stack_seeds(states) -> DracoState:
    """R solo states (each made by its own seed's `init_state`, at one
    window index) -> one seed-stacked state: each tensor with a leading R
    axis (copies), the R generators as a tuple."""
    states = list(states)
    if not states or len({s.window_idx for s in states}) != 1:
        raise ValueError("stack_seeds needs one or more states at one window index")

    def stack(*xs):
        return torch.stack(xs)

    first = states[0]
    return DracoState(
        params=flat_lib.tree_map(stack, *[s.params for s in states]),
        **{f: stack(*[getattr(s, f) for s in states])
           for f in ("pending", "buffer", "w_ring", "delay_ring", "accept_count",
                     "total_accept", "positions", "opt_state")},
        window_idx=first.window_idx,
        generator=tuple(s.generator for s in states))


def seed_row(state: DracoState, r: int) -> DracoState:
    """Seed `r` of a seed-stacked state, as a solo state of views."""
    return DracoState(
        params=flat_lib.tree_map(lambda p: p[r], state.params),
        **{f: getattr(state, f)[r]
           for f in ("pending", "buffer", "w_ring", "delay_ring", "accept_count",
                     "total_accept", "positions", "opt_state")},
        window_idx=state.window_idx,
        generator=state.generator[r])


# fields of a `DracoState` with a client axis, and where it lies past the
# seed axis: the params' and pending's first, the ring's and (sender axis)
# w_ring's and delay_ring's second
_CLIENT_AXIS = {"pending": 0, "buffer": 1, "w_ring": 1, "delay_ring": 1, "opt_state": 0}


def shard_state(state: DracoState, rows: slice) -> DracoState:
    """The client slice `rows` of a state (solo or seed-stacked), as a
    mesh window runs it (`draco_window`'s `mesh`): copies of those rows of
    params, pending, the payload ring, opt_state and the sender axis of
    ``w_ring`` and ``delay_ring``; accept counts, positions, the window
    index and the generator as they are."""
    lead = state.pending.dim() - 2

    def take(x, axis):
        return x.narrow(lead + axis, rows.start, rows.stop - rows.start).clone()

    return state._replace(params=flat_lib.tree_map(lambda p: take(p, 0), state.params),
                          **{f: take(getattr(state, f), a) for f, a in _CLIENT_AXIS.items()})


def gather_state(state: DracoState, mesh) -> DracoState:
    """Inverse of `shard_state` over a mesh: every client-sliced field
    gathered N-wide from the client ranks (on every rank)."""
    lead = state.pending.dim() - 2
    return state._replace(
        params=flat_lib.tree_map(lambda p: mesh.all_gather(p, lead), state.params),
        **{f: mesh.all_gather(getattr(state, f), lead + a) for f, a in _CLIENT_AXIS.items()})


def run_windows(state: DracoState, cfg: DracoConfig, q, adj, task, data,
                num_windows: int, *, draws_fn=None, drain=None,
                schedule=None) -> DracoState:
    """`num_windows` windows in a Python loop (the reference scans).

    `q` (N, N) row-stochastic weights; `draws_fn(window_idx)`, when
    given, injects each window's `WindowDraws`; `drain` as in
    `draco_window`. A `repro_torch.scenarios.Schedule`, when given,
    supplies each window's graph, positions and rates
    (``schedule.at(window_idx)``) in place of `q` and `adj`."""
    spec = flat_lib.spec_of(state.params)
    pos = compute_rate = tx_rate = None
    for _ in range(num_windows):
        if schedule is not None:
            v = schedule.at(state.window_idx)
            q, adj, pos, compute_rate, tx_rate = (v.q, v.adj, v.positions,
                                                  v.compute_rate, v.tx_rate)
        draws = None if draws_fn is None else draws_fn(state.window_idx)
        state = draco_window(state, cfg, q, adj, task, data, spec, draws=draws,
                             positions=pos, compute_rate=compute_rate,
                             tx_rate=tx_rate, drain=drain)
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


# ---------------------------------------------------------------------------
# The reference's seed engine (pre-fusion), the oracle of the fused window
# (tests/test_torch_legacy.py) and the baseline of the draco_window bench.
# Self-contained on purpose: it shares only `local_step` and `_psi_accept`
# with `draco_window`, so the two are independent gossip engines. Do not
# optimize.
# ---------------------------------------------------------------------------


class DracoStateLegacy(NamedTuple):
    """The reference's seed-layout state: per-leaf dicts, no flat plane;
    ``key`` replaced by a `torch.Generator`, ``window_idx`` a host int."""

    params: Dict[str, Any]  # {name: (N, ...)}
    pending: Dict[str, Any]  # {name: (N, ...)} accumulated untransmitted updates
    buffer: Dict[str, Any]  # {name: (D, N, ...)} in-flight already-mixed deltas
    accept_count: torch.Tensor  # (N,) int32 — accepted this period
    total_accept: torch.Tensor  # (N,) int32 — accepted over the whole run
    window_idx: int
    generator: torch.Generator
    positions: torch.Tensor  # (N, 2) node coordinates (channel model)
    opt_state: Optional[torch.Tensor] = None  # (N, Dopt) f32 local optimizer plane


def init_state_legacy(key, cfg: DracoConfig, params0, task=None, *,
                      device=None) -> DracoStateLegacy:
    """The legacy layout of `init_state`: params0 replicated across N
    clients, zero per-leaf pending and ring buffers. `key` (an int seed
    or a `torch.Generator`) draws the node positions first, as
    `init_state` does, so one seed gives both engines the same positions
    and window draws. `task` sizes the optimizer plane as in
    `init_state`."""
    g = as_generator(key, device)
    dev = g.device
    n, d = cfg.num_clients, cfg.max_delay_windows
    params = flat_lib.tree_map(
        lambda p: p.to(dev).unsqueeze(0).repeat((n,) + (1,) * p.dim()), params0)
    pos = channel_lib.place_nodes(g, n, cfg.channel or ChannelConfig())
    return DracoStateLegacy(
        params=params,
        pending=flat_lib.tree_map(torch.zeros_like, params),
        buffer=flat_lib.tree_map(
            lambda p: torch.zeros((d,) + tuple(p.shape), dtype=p.dtype, device=dev),
            params),
        accept_count=torch.zeros((n,), dtype=torch.int32, device=dev),
        total_accept=torch.zeros((n,), dtype=torch.int32, device=dev),
        window_idx=0,
        generator=g,
        positions=pos,
        opt_state=opt_plane(task, params0, n, dev),
    )


def draco_window_legacy(state: DracoStateLegacy, cfg: DracoConfig, q, adj, loss_fn,
                        data, *, draws: Optional[WindowDraws] = None) -> DracoStateLegacy:
    """Seed window: D-1 per-bucket contractions of every leaf at enqueue
    time; returns the next state.

    `q` (N, N) row-stochastic weights, `adj` (N, N) its adjacency;
    `loss_fn` a bare batched loss or a `Task`; `data` the shards. `draws`
    injects this window's `WindowDraws` (the fields and order of
    `draco_window`'s), None draws them from ``state.generator``. The
    config's rates, Psi and lr are used as they are: no scenario and no
    sweep override, as in the reference.

    The ring slot being delivered is zeroed in place and the enqueue adds
    into the other slots in place, so a state is consumed by the window
    that advances it."""
    n, D = cfg.num_clients, cfg.max_delay_windows
    widx = state.window_idx
    if draws is None:
        draws = sample_window_draws(state.generator, cfg, data[0].shape[1])

    # --- 1. deliveries: this window's ring slot, then cleared -----------
    slot = widx % D
    params = flat_lib.tree_map(lambda p, b: p + b[slot].to(p.dtype), state.params,
                               state.buffer)
    for b in flat_lib.tree_leaves(state.buffer):
        b[slot].zero_()

    # --- 2. gradient events ------------------------------------------------
    delta, opt_state = local_step(params, draws.grad_mask, cfg, loss_fn, data,
                                  draws.batch_idx, state.opt_state, widx)
    pending = flat_lib.tree_map(lambda a, b: a + b, state.pending, delta)
    if cfg.apply_self_update:
        params = flat_lib.tree_map(lambda p, dl: p + dl.to(p.dtype), params, delta)

    # --- 3. transmission events + channel ----------------------------------
    tx_mask = draws.tx_mask
    if cfg.channel is not None and cfg.channel.enabled:
        gamma, success = channel_lib.transmission_delays(
            draws.fading, state.positions, tx_mask, cfg.channel)
        # compare and clip in float before the int cast: XLA saturates an
        # out-of-range cast, torch wraps it (an outage's inf would become
        # INT_MIN, a one-window delivery). A link spanning >= D windows
        # cannot live in a depth-D ring: dropped, never delivered early.
        delay_raw = torch.ceil(gamma / cfg.window)
        delay_w = torch.clamp(delay_raw, 1, D - 1).to(torch.int32)
        success = success & (delay_raw <= D - 1) & adj
    else:
        success = adj & tx_mask[:, None]
        delay_w = torch.ones((n, n), dtype=torch.int32, device=q.device)
    accept, accept_count = _psi_accept(success, state.accept_count, cfg.psi, draws.perm)
    # the cumulative counter survives the periodic accept_count reset
    total_accept = state.total_accept + (accept_count - state.accept_count)
    w_eff = q * accept.to(q.dtype)  # (sender, receiver)

    # enqueue into the ring, bucketed by relative delay: one contraction
    # per bucket and leaf
    for buf, pend in zip(flat_lib.tree_leaves(state.buffer), flat_lib.tree_leaves(pending)):
        for d in range(1, D):
            w_d = w_eff * (delay_w == d).to(q.dtype)
            contrib = torch.einsum("nm,n...->m...", w_d, pend.to(torch.float32))
            buf[(widx + d) % D] += contrib.to(buf.dtype)

    # senders clear their pending backlog (Lemma A.1 backups are now sent)
    keep = (~tx_mask).to(torch.float32)
    pending = flat_lib.tree_map(
        lambda pnd: pnd * keep.reshape((n,) + (1,) * (pnd.dim() - 1)), pending)

    # --- 4. periodic unification -------------------------------------------
    # repro-lint: disable-next-line=TRACED-PY-BRANCH(window_idx is a host int, never a tensor: the unify decision is host arithmetic)
    if cfg.unify_period > 0 and (widx + 1) % cfg.unify_period == 0:
        hub = (widx // cfg.unify_period) % n
        params = flat_lib.tree_map(lambda x: x[hub].unsqueeze(0).expand_as(x).clone(),
                                   params)
        accept_count = torch.zeros_like(accept_count)

    return DracoStateLegacy(
        params=params, pending=pending, buffer=state.buffer, accept_count=accept_count,
        total_accept=total_accept, window_idx=widx + 1, generator=state.generator,
        positions=state.positions, opt_state=opt_state)


def run_windows_legacy(state: DracoStateLegacy, cfg: DracoConfig, q, adj, loss_fn, data,
                       num_windows: int, *, draws_fn=None) -> DracoStateLegacy:
    """`num_windows` legacy windows in a Python loop (the reference
    scans); `q` (N, N) row-stochastic, `draws_fn(window_idx)` injects each
    window's `WindowDraws` when given."""
    for _ in range(num_windows):
        draws = None if draws_fn is None else draws_fn(state.window_idx)
        state = draco_window_legacy(state, cfg, q, adj, loss_fn, data, draws=draws)
    return state

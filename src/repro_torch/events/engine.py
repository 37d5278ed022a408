"""The continuous-time event engine (port of `repro.events.engine`).

One `event_step` consumes one row of the context's `EventTape`. The
tape is host numpy and the port dispatches on its kind in Python:

  KIND_GRAD   B local batches through the task's optimizer plane
              (`protocol.local_step` over all N clients with a one-hot
              grad mask, as the reference runs it), into the acting
              client's pending backlog;
  KIND_TX     the acting client broadcasts its backlog through the
              (optional) wireless channel into the payload ring, under
              the Psi cap and, for `event-triggered`, the backlog
              threshold;
  KIND_UNIFY  every client adopts the tape's hub (`unify_hub`).

Before the dispatch every valid event **drains**: ring messages whose
delivery deadline ``t_send + gamma_link`` has passed are mixed into the
receivers by `gossip_ops.gossip_drain`, the hand-written drain kernel
the windowed engine uses (its second caller), one launch per valid
event. The ring is deadline-stamped: `w_ring` holds the undelivered
effective weights, `deadline_ring` the per-link delivery times, and a
drain zeroes exactly what it delivered, so one broadcast's links can
arrive at different events. Broadcast ``b`` lives in slot ``b % D``;
enqueueing it evicts broadcast ``b - D``. A drain walks the D slots
oldest broadcast first, so the f32 sums follow send order, as the eager
oracle `repro_torch.events.replay` does (bit for bit on the CPU). Most
events find nothing due: the kernel finds the live buckets on the
device, so an empty drain costs the zero write of the (N, Dflat) plane
and no host read.

Host state. ``tx_count`` (the slot allocator), the tape cursor
``event_idx`` and the clock ``time`` (numpy f32) are host values, so the
drain's slots are host ints. Every TX row of `draco-event` and
`fedasync-gossip` fires, so they read nothing from the device.
`event-triggered` decides on the device whether a TX row fires (the
sender's backlog norm against the threshold); the decision sets the
slot written and every later slot order, so it is read on the host: one
sync per TX row of that algorithm only.

Time arithmetic is f32, as in the reference: ``step_t = floor(t /
window)`` in numpy f32, deadlines ``t + gamma`` and ages ``(t -
send_time) / window`` as f32 tensor ops.

Padding rows (``valid == False``) are strict no-ops: no draw, no
launch, no state change but the cursor, so a padded tape equals its
unpadded prefix bit for bit.

Randomness. A valid event draws its `EventDraws` from the state's
generator: a grad event the batch rows of all N clients, a TX event
with the channel on the (N, N) fading; tests inject the record the
reference's 4-way key split gives.

A client mesh (`event_step`'s ``mesh``, a `repro_torch.launch.mesh.Mesh`):
the state holds this rank's clients (`shard_state`: the rows of
``params``, ``pending``, ``opt_state`` and the payload ring, and the
sender rows of ``w_ring`` and ``deadline_ring``); the send times, the
counters and the positions stay N-wide, and the draws, the channel and
Psi are computed N-wide on every rank from the same generator. Every
valid event drains through `gossip_drain_sharded` (the rank's senders
against every receiver, then one reduce-scatter), an empty drain
included, as the reference's sharded drain does. A grad event runs the
local step on the rank's rows; a TX event writes the rank's sender rows
of the slot; `event-triggered`'s fire decision is taken by the rank that
holds the sender's backlog and broadcast to the others (its one host
read); a unification broadcasts the hub's row from the rank that holds
it.
"""
# repro-lint: disable-file=TRACED-PY-BRANCH(event_step runs eagerly, one tape row per Python call: the tape, cursor, clock and tx_count are host numpy and ints, and the branches on them are host control flow, never a traced value), HOST-SYNC-IN-JIT(the int and float reads are of host numpy tape entries; the one device read, event-triggered's fire decision, is deliberate and counted by chip_smoke.py)
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import as_generator
from repro_torch.core import channel as channel_lib
from repro_torch.core import flat as flat_lib
from repro_torch.core import protocol as protocol_lib
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.protocol import rebound
from repro_torch.events.tape import KIND_GRAD, KIND_TX, KIND_UNIFY
from repro_torch.kernels.gossip import ops as gossip_ops


class EventState(NamedTuple):
    params: Dict[str, Any]  # {name: (N, ...)}
    pending: torch.Tensor  # (N, Dflat) f32 — untransmitted backlog (Lemma A.1)
    buffer: torch.Tensor  # (D, N, Dflat) f32 — raw broadcast payload ring
    w_ring: torch.Tensor  # (D, N, N) f32 — undelivered effective weights
    deadline_ring: torch.Tensor  # (D, N, N) f32 — absolute delivery times (s)
    send_time: torch.Tensor  # (D,) f32 — slot send times (staleness)
    accept_count: torch.Tensor  # (N,) int32 — accepted this unification period
    total_accept: torch.Tensor  # (N,) int32 — accepted over the whole run
    tx_sent: torch.Tensor  # (N,) int32 — broadcasts that fired
    tx_count: int  # broadcast counter / slot allocator
    event_idx: int  # tape cursor
    time: np.float32  # last processed event time (s)
    generator: torch.Generator
    positions: torch.Tensor  # (N, 2) node coordinates (channel model)
    opt_state: Optional[torch.Tensor] = None  # (N, Dopt) f32 local optimizer plane


class EventDraws(NamedTuple):
    """One event's random outcomes, the counterpart of `WindowDraws`."""

    batch_idx: Optional[torch.Tensor] = None  # (N, B, batch_size) int64, grad events
    fading: Optional[torch.Tensor] = None  # (N, N) f32, TX events with the channel on


def init_event_state(key, cfg, params0, task=None, *, device=None) -> EventState:
    """Replicate `params0` across N clients; empty rings and counters.

    The generator places the nodes first, as `protocol.init_state` does,
    so an event run and a windowed run from one seed share positions.
    ``device=None`` means CUDA."""
    g = as_generator(key, device)
    dev = g.device
    n, d = cfg.num_clients, cfg.max_delay_windows
    params = flat_lib.tree_map(
        lambda p: p.to(dev).unsqueeze(0).repeat((n,) + (1,) * p.dim()), params0)
    dim = flat_lib.spec_of(params).dim
    pos = channel_lib.place_nodes(g, n, cfg.channel or ChannelConfig())

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EventState(
        params=params, pending=zeros((n, dim)), buffer=zeros((d, n, dim)),
        w_ring=zeros((d, n, n)), deadline_ring=zeros((d, n, n)), send_time=zeros((d,)),
        accept_count=zeros((n,), torch.int32), total_accept=zeros((n,), torch.int32),
        tx_sent=zeros((n,), torch.int32), tx_count=0, event_idx=0, time=np.float32(0.0),
        generator=g, positions=pos,
        opt_state=protocol_lib.opt_plane(task, params0, n, dev))


def sample_event_draws(generator: torch.Generator, cfg, num_samples: int,
                       kind: int) -> EventDraws:
    """One valid event's draws from `generator`: the batch rows of all N
    clients for a grad event, the fading of a TX event with the channel
    on, nothing otherwise."""
    n, dev = cfg.num_clients, generator.device
    if kind == KIND_GRAD:
        return EventDraws(batch_idx=torch.randint(
            0, num_samples, (n, cfg.local_batches, cfg.batch_size),
            generator=generator, device=dev))
    if kind == KIND_TX and cfg.channel is not None and cfg.channel.enabled:
        return EventDraws(fading=torch.empty((n, n), dtype=torch.float32, device=dev)
                          .exponential_(generator=generator))
    return EventDraws()


def event_view(ctx, t: np.float32):
    """``(step_t, q, adj, positions or None)`` at event time `t`: the
    schedule's snapshot of window ``floor(t / window)``, in f32 as the
    reference computes it, or the frozen graph."""
    step_t = int(np.floor(np.float32(t) / np.float32(ctx.cfg.window)))
    if ctx.schedule is None:
        return step_t, ctx.q, ctx.adj, None
    v = ctx.schedule.at(step_t)
    return step_t, v.q, v.adj, v.positions


def _fires(pending, ci: int, n: int, trigger: float, mesh) -> bool:
    """Whether client `ci`'s TX row fires: its backlog's L2 norm against
    `trigger` (always, at 0), read on the host. On a `mesh` the rank that
    holds the backlog decides and broadcasts, so every rank takes the
    same decision (it sets the slot written and every later one)."""
    if trigger <= 0:
        return True
    thr = float(np.float32(trigger) ** 2)
    if mesh is None:
        row = pending[ci]
    else:
        src = mesh.owner(ci, n)
        row = pending[ci - src * (n // mesh.size) if src == mesh.rank else 0]
    fire = (row.square().sum() >= thr).to(torch.int32)
    if mesh is not None:
        fire = mesh.broadcast(fire, src)
    # repro-lint: disable-next-line=TENSOR-PY-BRANCH(event-triggered reads its fire decision on the host once per TX row by design, PERF.md section 2; the other event modes pass trigger 0 and return before it)
    return bool(fire)


def event_step(state: EventState, ctx, *, damping=None, trigger: float = 0.0,
               draws: Optional[EventDraws] = None, drain=None, mesh=None) -> EventState:
    """One tape row: drain what is due, then dispatch on the event kind.

    `ctx` is a `SimContext` carrying an `EventTape` (see
    `repro_torch.events.driver.events_context`); its `overrides` re-bind
    lr and psi (a sweep row's). `damping` is the staleness closure (None:
    undamped DRACO semantics, bit for bit); `trigger` the suppression
    threshold (0: always fire). `draws` injects the event's
    `EventDraws`; `drain` is the drain function (`gossip_ops.gossip_drain`
    when None, `gossip_drain_sharded` on a `mesh`). `mesh` runs the event
    on this rank's clients of a sharded state (see the module
    docstring). The rings are written in place: a state is consumed by
    the step that advances it."""
    tape = ctx.tape
    if tape is None:
        raise ValueError(
            "event algorithms need a ctx carrying an EventTape; build one "
            "with repro_torch.events.events_context(...) or call simulate_events")
    e = state.event_idx
    if not tape.valid[e]:  # padding: a strict no-op
        return state._replace(event_idx=e + 1)
    cfg = ctx.cfg
    n, D = cfg.num_clients, cfg.max_delay_windows
    sl = slice(0, n) if mesh is None else mesh.client_slice(n)  # this rank's clients
    spec = (ctx.flat_spec if ctx.flat_spec is not None and mesh is None
            else flat_lib.spec_of(state.params))
    t, ci, kind = tape.t[e], int(tape.client[e]), int(tape.kind[e])
    tf = float(t)  # the f32 value, exact as a Python float
    step_t, q, adj, sched_pos = event_view(ctx, t)
    pos = state.positions if sched_pos is None else sched_pos
    if draws is None:
        draws = sample_event_draws(state.generator, cfg, ctx.data[0].shape[1], kind)
    if drain is None and mesh is not None:
        drain = protocol_lib.mesh_drain(mesh)
    drain = gossip_ops.gossip_drain if drain is None else drain

    # --- 1. continuous-time drain: everything due by t, oldest first --------
    # slot i of the drain is ring row (tx_count + i) % D: a roll, with no
    # host index list to copy to the device
    slots = [(state.tx_count + i) % D for i in range(D)]
    shift = -(state.tx_count % D)
    due = state.deadline_ring <= tf  # (D, N, N)
    w_stack = torch.roll(state.w_ring * due.to(state.w_ring.dtype), shift, dims=0)
    if damping is not None:
        dtau = (tf - torch.roll(state.send_time, shift, dims=0)) / cfg.window
        w_stack = w_stack * damping(dtau)[:, None, None]
    arrivals = flat_lib.unravel_clients(drain(w_stack, state.buffer, slots), spec)
    params = flat_lib.tree_map(lambda p, a: p + a.to(p.dtype), state.params, arrivals)
    state.w_ring.mul_((~due).to(state.w_ring.dtype))

    pending, opt_state = state.pending, state.opt_state
    acc, tot, sent, txc = state.accept_count, state.total_accept, state.tx_sent, state.tx_count
    # --- 2. dispatch on the event kind --------------------------------------
    if kind == KIND_GRAD:
        gm = torch.arange(n, device=pending.device)[sl] == ci
        delta, opt_state = protocol_lib.local_step(
            params, gm, cfg, ctx.task, ctx.data, draws.batch_idx[sl], opt_state, step_t,
            lr=rebound(cfg, ctx.overrides, "lr"))
        pending = pending + flat_lib.ravel_clients(delta)
        if cfg.apply_self_update:
            params = flat_lib.tree_map(lambda p, dl: p + dl.to(p.dtype), params, delta)
    elif kind == KIND_TX:
        sender = torch.arange(n, device=pending.device) == ci
        # suppression: the backlog's norm against the threshold, read on the
        # host (the one sync of event-triggered's TX rows)
        # repro-lint: disable-next-line=TENSOR-PY-BRANCH(_fires returns a host bool, read once per TX row of event-triggered only)
        if _fires(pending, ci, n, trigger, mesh):
            if cfg.channel is not None and cfg.channel.enabled:
                gamma, success = channel_lib.transmission_delays(
                    draws.fading, pos, sender, cfg.channel)
                success = success & adj
                deadlines = (tf + gamma).to(torch.float32)
            else:
                # gamma = 0: due at the next strictly later event (the
                # window -> 0 limit of the windowed engine's one-window delay)
                success = adj & sender[:, None]
                deadlines = torch.full((n, n), tf, dtype=torch.float32, device=adj.device)
            # Psi cap: a single sender needs no priority permutation
            psi = rebound(cfg, ctx.overrides, "psi")
            accept = success if psi <= 0 else success & (acc[None, :] < psi)
            newly = accept.sum(dim=0, dtype=torch.int32)
            acc, tot = acc + newly, tot + newly
            slot = txc % D  # evicts broadcast txc - D
            state.buffer[slot].copy_(pending)
            state.w_ring[slot].copy_((q * accept.to(q.dtype))[sl])
            state.deadline_ring[slot].copy_(deadlines[sl])
            state.send_time[slot].fill_(tf)
            sent = sent + sender.to(torch.int32)
            txc += 1
            pending = pending * (~sender[sl]).to(torch.float32)[:, None]
    elif kind == KIND_UNIFY:
        # hub = tape.client (the precomputed rotating hub, `unify_hub`)
        params = protocol_lib.adopt_hub(params, ci, n, mesh=mesh)
        acc = torch.zeros_like(acc)
    else:
        raise ValueError(f"unknown event kind {kind}")
    return state._replace(
        params=params, pending=pending, accept_count=acc, total_accept=tot, tx_sent=sent,
        tx_count=txc, event_idx=e + 1, time=np.float32(t), positions=pos,
        opt_state=opt_state)


# fields of an `EventState` with a client axis, and which axis: the
# backlog's and the optimizer plane's first, the payload ring's and (the
# sender axis) w_ring's and deadline_ring's second
_CLIENT_AXIS = {"pending": 0, "opt_state": 0, "buffer": 1, "w_ring": 1, "deadline_ring": 1}


def shard_state(state: EventState, rows: slice) -> EventState:
    """The client slice `rows` of a state, as a mesh event runs it
    (`event_step`'s `mesh`): copies of those rows of ``params``,
    ``pending``, ``opt_state`` and the payload ring, and of the sender
    axis of ``w_ring`` and ``deadline_ring``; the send times, counters,
    positions, cursor, clock and generator as they are."""
    return protocol_lib.shard_state(state, rows, _CLIENT_AXIS)


def gather_state(state: EventState, mesh) -> EventState:
    """Inverse of `shard_state` over a mesh: every client-sliced field
    gathered N-wide from the client ranks (on every rank)."""
    return protocol_lib.gather_state(state, mesh, _CLIENT_AXIS)


def run_events(state: EventState, ctx, num_events: int, *, damping=None,
               trigger: float = 0.0, draws_fn=None, drain=None) -> EventState:
    """`num_events` tape rows in a Python loop; `draws_fn(event_idx)`, when
    given, injects each row's `EventDraws`; `drain` as in `event_step`."""
    for _ in range(num_events):
        draws = None if draws_fn is None else draws_fn(state.event_idx)
        state = event_step(state, ctx, damping=damping, trigger=trigger, draws=draws,
                           drain=drain)
    return state

"""Step-by-step eager replay of an event tape: the engine's oracle (port
of `repro.events.replay`).

An independent re-implementation of the event semantics: a Python loop
over the tape's valid rows with a plain message *list* instead of
rings. Enqueue appends, the depth-D outage bound evicts by broadcast
index, and draining walks the live messages in send order with one
plain ``w_due.T @ payload`` GEMM each (never the drain kernel). No slot
arithmetic, no fixed-capacity buffers.

It equals `repro_torch.events.engine` bit for bit on the CPU (where the
engine's drain is the plain loop) because both keep the contracts that
decide the floats:

  - randomness: the same `sample_event_draws` calls per valid event, in
    tape order (padding rows draw nothing on either side);
  - drain order: oldest broadcast first, one f32 GEMM accumulation per
    live message, all-zero messages skipped (exact: they add +-0);
  - damping order: ``(w * due_mask) * s(dtau)``;
  - local updates: the same `protocol.local_step` call with the same
    one-hot mask.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import channel as channel_lib
from repro_torch.core import flat as flat_lib
from repro_torch.core import protocol as protocol_lib
from repro_torch.events.engine import event_view, sample_event_draws
from repro_torch.events.tape import KIND_GRAD, KIND_TX, KIND_UNIFY


class ReplayResult(NamedTuple):
    """The replayed run's observable state (ring internals excluded: the
    replay keeps messages in a list, not a ring)."""

    params: Any
    pending: torch.Tensor
    opt_state: torch.Tensor
    accept_count: torch.Tensor
    total_accept: torch.Tensor
    tx_sent: torch.Tensor
    tx_count: int
    time: float
    positions: torch.Tensor


def replay_events(state, ctx, *, damping=None, trigger: float = 0.0,
                  draws_fn=None) -> ReplayResult:
    """Replay ``ctx.tape`` from an initial `EventState`, eagerly.

    Mirrors `engine.event_step` with independent bookkeeping; `damping`
    and `trigger` as there. Draws come from the state's generator (use a
    state of its own: the replay advances it) or from `draws_fn(e)`. The
    static-config oracle: ``ctx.overrides`` must be None."""
    tape, cfg = ctx.tape, ctx.cfg
    n, D = cfg.num_clients, cfg.max_delay_windows
    spec = ctx.flat_spec if ctx.flat_spec is not None else flat_lib.spec_of(state.params)
    if ctx.overrides is not None and any(f is not None for f in ctx.overrides):
        raise ValueError("replay_events is the static-config oracle; "
                         "run it without overrides")
    params, pending, opt_state = state.params, state.pending, state.opt_state
    acc, tot, sent = state.accept_count, state.total_accept, state.tx_sent
    positions, txc, t = state.positions, int(state.tx_count), np.float32(state.time)
    dev = pending.device
    msgs = []  # dicts: born, w (N,N), deadline (N,N), payload (N,Dflat), sent_at

    for e in range(tape.capacity):
        if not tape.valid[e]:
            continue
        t = tape.t[e]
        tf, ci, kind = float(t), int(tape.client[e]), int(tape.kind[e])
        step_t, q, adj, sched_pos = event_view(ctx, t)
        pos = positions if sched_pos is None else sched_pos
        draws = (draws_fn(e) if draws_fn is not None else
                 sample_event_draws(state.generator, cfg, ctx.data[0].shape[1], kind))

        # --- drain: live messages in send order, one GEMM each -----------
        arrivals = torch.zeros((n, spec.dim), dtype=torch.float32, device=dev)
        for m in msgs:
            w_due = m["w"] * (m["deadline"] <= tf).to(m["w"].dtype)
            if damping is not None:
                w_due = w_due * damping((tf - m["sent_at"]) / cfg.window)
            if bool(torch.any(w_due != 0)):
                arrivals = arrivals + w_due.T @ m["payload"]
            m["w"] = m["w"] * (m["deadline"] > tf).to(m["w"].dtype)
        params = flat_lib.tree_map(lambda p, a: p + a.to(p.dtype), params,
                                   flat_lib.unravel_clients(arrivals, spec))

        # --- dispatch -----------------------------------------------------
        if kind == KIND_GRAD:
            gm = torch.arange(n, device=dev) == ci
            delta, opt_state = protocol_lib.local_step(
                params, gm, cfg, ctx.task, ctx.data, draws.batch_idx, opt_state, step_t)
            pending = pending + flat_lib.ravel_clients(delta)
            if cfg.apply_self_update:
                params = flat_lib.tree_map(lambda p, dl: p + dl.to(p.dtype), params, delta)
        elif kind == KIND_TX:
            sender = torch.arange(n, device=dev) == ci
            if cfg.channel is not None and cfg.channel.enabled:
                gamma, success = channel_lib.transmission_delays(
                    draws.fading, pos, sender, cfg.channel)
                success = success & adj
                deadlines = (tf + gamma).to(torch.float32)
            else:
                success = adj & sender[:, None]
                deadlines = torch.full((n, n), tf, dtype=torch.float32, device=dev)
            fire = trigger <= 0 or bool(
                torch.sum(pending[ci] ** 2) >= float(np.float32(trigger) ** 2))
            if fire:
                room = success if cfg.psi <= 0 else success & (acc[None, :] < cfg.psi)
                newly = room.sum(dim=0, dtype=torch.int32)
                acc, tot = acc + newly, tot + newly
                msgs.append({"born": txc, "w": q * room.to(q.dtype), "deadline": deadlines,
                             "payload": pending,
                             "sent_at": torch.tensor(tf, dtype=torch.float32, device=dev)})
                txc += 1
                # depth-D ring: broadcast txc - 1 evicts broadcast txc - 1 - D
                msgs = [m for m in msgs if m["born"] >= txc - D]
                pending = pending * (~sender).to(torch.float32)[:, None]
                sent = sent + sender.to(torch.int32)
        elif kind == KIND_UNIFY:
            params = flat_lib.tree_map(lambda x: x[ci].expand_as(x).clone(), params)
            acc = torch.zeros_like(acc)
        else:
            raise ValueError(f"unknown event kind {kind}")
        positions = pos

    return ReplayResult(params=params, pending=pending, opt_state=opt_state,
                        accept_count=acc, total_accept=tot, tx_sent=sent, tx_count=txc,
                        time=float(t), positions=positions)

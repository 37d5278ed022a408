"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch.

Port of `repro.models.moe`. Tokens are ranked within their expert's queue
by a stable argsort, clipped to a per-expert capacity ``C`` (dropped
tokens pass through the residual), gathered into an ``(E, C, d)`` buffer,
run through the experts as three batched products over the stacked
expert weights, and combined with their renormalised gates.

The capacity is computed on the host from shapes only and the expert
counts on the device, so the layer reads nothing back from the device.
The dispatch and the combine are autograd functions (`_Dispatch`,
`_Combine`) whose forwards and backwards are gathers, summed over a
token's k choices in a fixed order in f32 (f64 for f64) before one
rounding: deterministic on the card, and never a (T * k, d) tensor. The
only repeated index is the zero row of the drop bin (the reference's
scatter-add ``buf.at[dst].add`` is equal to the gather: every kept slot
receives exactly one row). The reference's ``constrain`` calls only
place the expert axis on a device mesh and are left out on one device.

The expert axis over "model" (`repro_torch.sharding.tp`). Where a rank's
``experts_*`` blocks hold E / T of the experts (the reference's rules
lay the expert axis on "model"; `router` is replicated), the rank routes
all T tokens exactly as one process does (the router in f32, top-k, the
capacity from all T tokens, the aux loss: alike on every rank), builds
the ``(E / T, C, d)`` buffer of its own experts by indexing the tokens
with each of its slots' token, runs the three products over them, and
combines only its own slots into a partial output: the same path as one
device's, over a share of the experts. The dispatch and the combine sum
over the model ranks where a partial part meets a whole one, each in f32
before its one rounding, as one process rounds: the combined output in
the forward, and backward the dispatched rows' gradient and the gates'
(`TP.copy`'s place, where the partial part enters); the router side's
gradients are whole on every rank and are summed nowhere. Where E does not divide by T the experts stay replicated
(`filter_divisible`) and every rank runs them all, with nothing reduced.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(generator: torch.Generator, cfg):
    """``{router (d, E) f32, experts_gate, experts_up (E, d, f),
    experts_down (E, f, d)}``, the experts in ``cfg.dtype``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dtype = cfg.torch_dtype
    return {
        "router": dense_init(generator, (d, E), d, torch.float32),
        "experts_gate": dense_init(generator, (E, d, f), d, dtype),
        "experts_up": dense_init(generator, (E, d, f), d, dtype),
        "experts_down": dense_init(generator, (E, f, d), f, dtype),
    }


def _capacity(T: int, cfg) -> int:
    """Per-expert queue length: ``int(cf * k * T / E)`` rounded up to a
    multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * cfg.experts_per_token * T / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


class _Dispatch(torch.autograd.Function):
    """``xt (T, d)`` -> the rows of slots ``tok (S,)`` (T: an empty slot,
    the zero row). Backward: each token's k slots ``dst (T, k)`` (S: not
    one of these slots) gathered and summed in order, in f32 (f64 for
    f64); with `tp` (the rank's slots are a share of them) that partial
    sum is summed over the model ranks before its one rounding."""

    @staticmethod
    def forward(ctx, xt, tok, dst, tp):
        ctx.save_for_backward(dst)
        ctx.tp = tp
        return torch.cat([xt, xt.new_zeros(1, xt.shape[1])])[tok]

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(1, g.shape[1])])
        acc = torch.zeros((dst.shape[0], g.shape[1]), device=g.device,
                          dtype=torch.promote_types(g.dtype, torch.float32))
        for j in range(dst.shape[1]):
            acc += g[dst[:, j]]
        if ctx.tp is not None:
            acc = ctx.tp.mesh.model_all_reduce(acc)
        return acc.to(g.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """``out_e (S, d)``, ``gate (T, k)`` -> ``(T, d)`` in f32 (f64 for
    f64): each token's gated slot outputs ``dst (T, k)`` (S: none)
    summed, as the one-process combine sums them before its one rounding
    to ``out_e``'s dtype; with `tp` the ranks' partial sums are summed
    over the model ranks (under sequence parallelism reduce-scattered
    along the sequence of the `batch` rows of T / batch tokens: the
    output is then ``(batch, T / batch / size, d)``, the rank's
    positions). Backward: the gates' gradient per choice (summed over
    the model ranks with `tp`: each rank's is its slots'), and each
    slot's gradient gathered from its token and choice ``src (S,)`` (T *
    k: an empty slot)."""

    @staticmethod
    def forward(ctx, out_e, gate, dst, src, tp, batch=0):
        ctx.save_for_backward(out_e, gate, dst, src)
        ctx.tp, ctx.seq = tp, tp is not None and tp.seq
        rows = torch.cat([out_e, out_e.new_zeros(1, out_e.shape[1])])
        g = gate.to(out_e.dtype)
        acc = torch.zeros((dst.shape[0], out_e.shape[1]), device=out_e.device,
                          dtype=torch.promote_types(out_e.dtype, torch.float32))
        for j in range(dst.shape[1]):
            acc += rows[dst[:, j]] * g[:, j, None]
        if tp is None:
            return acc
        if ctx.seq:
            return tp.mesh.model_reduce_scatter(acc.reshape(batch, -1, acc.shape[1]), 1)
        return tp.mesh.model_all_reduce(acc)

    @staticmethod
    def backward(ctx, go):
        out_e, gate, dst, src = ctx.saved_tensors
        k = dst.shape[1]
        rows = torch.cat([out_e, out_e.new_zeros(1, out_e.shape[1])])
        g_out = g_gate = None
        if ctx.seq:  # the whole sequence's gradient of the rank's positions
            go = ctx.tp.mesh.model_all_gather(go, 1).reshape(-1, go.shape[-1])
        go = go.to(out_e.dtype)
        if ctx.needs_input_grad[0]:
            go_rows = torch.cat([go, go.new_zeros(1, go.shape[1])])
            gates = torch.cat([gate.reshape(-1), gate.new_zeros(1)])
            g_out = go_rows[torch.div(src, k, rounding_mode="floor")] \
                * gates[src].to(go.dtype)[:, None]
        if ctx.needs_input_grad[1]:
            g_gate = torch.stack([(go * rows[dst[:, j]]).sum(-1) for j in range(k)],
                                 1).to(gate.dtype)
            if ctx.tp is not None:
                g_gate = ctx.tp.mesh.model_all_reduce(g_gate)
        return g_out, g_gate, None, None, None, None


def _own_experts(params, xt, gate, flat_e, rank, keep, C, tp, batch=0):
    """The layer's output (T, d) from the experts of `params`: its slots'
    buffer, the products, its slots combined. With `tp` the blocks hold
    the rank's share of the experts and the output is summed over the
    model ranks (see the module docstring; under sequence parallelism
    reduce-scattered to the rank's positions of the `batch` rows); without,
    they are all E."""
    T, d = xt.shape
    k = gate.shape[1]
    e_loc = params["experts_gate"].shape[0]
    e0 = 0 if tp is None else tp.rank * e_loc
    n = e_loc * C
    mine = keep & (flat_e >= e0) & (flat_e < e0 + e_loc)
    dst = torch.where(mine, (flat_e - e0) * C + rank, n)  # n = the drop bin
    src = torch.full((n + 1,), T * k, dtype=torch.long, device=xt.device)
    src[dst] = torch.arange(T * k, device=xt.device)  # repeats only in the drop bin
    src, dst = src[:n], dst.reshape(T, k)
    tok = torch.div(src, k, rounding_mode="floor")  # T for an empty slot
    buf = _Dispatch.apply(xt, tok, dst, tp).reshape(e_loc, C, d)
    h = F.silu(torch.bmm(buf, params["experts_gate"])) * torch.bmm(buf, params["experts_up"])
    out_e = torch.bmm(h, params["experts_down"]).reshape(n, d)
    return _Combine.apply(out_e, gate, dst, src, tp, batch).to(xt.dtype)


def _queue_rank(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """The rank of each (token, choice) of `flat_e` within its expert's
    queue, in token order."""
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    rank_sorted = torch.arange(flat_e.shape[0], device=dev) - starts[sorted_e]
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


def moe_block(params, x: torch.Tensor, cfg, tp=None, rows=None):
    """x (B, S, d) -> (out (B, S, d), aux loss 0-d f32).

    Router logits, softmax and top-k in f32 (f64 for an f64 model, the
    exact-arithmetic witness); gates renormalised over the
    k chosen (floored at 1e-9); the Switch load-balance loss
    ``E * sum(density * mean prob) * router_aux_weight``. `tp`: the
    rank's place on "model", whose experts it runs when its blocks hold
    a share of them (see the module docstring). `rows`
    (`repro_torch.sharding.tp.Rows`): `x` is this client rank's rows of
    a batch split over the client ranks (serving); the queues and the
    capacity are then the whole batch's, every rank's choices gathered
    in rank order, so a token is dropped exactly where one device would
    drop it (the aux loss stays the rank's rows').

    Under sequence parallelism (``tp.seq``) x is the rank's positions:
    the layer gathers the whole sequence first (`TP.gather`), so that
    the routing, the capacity, the queues and the aux loss are the
    client's whole B * S tokens' alike on every rank, as without the
    flag (a rank routing its positions alone would pick other experts),
    and the gradient of the gathered input, whole on every rank (the
    router's is, and the dispatch sums its rows' over the ranks), is
    kept at the rank's positions. The combine's sum over the ranks is
    then a reduce-scatter along the sequence (replicated experts: the
    whole output kept at the rank's positions, `TP.split`)."""
    seq = tp is not None and tp.seq
    if seq:
        x = tp.gather(x, 1)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    dev = x.device

    rdt = torch.promote_types(x.dtype, torch.float32)  # f32, f64 for an f64 model
    logits = xt.to(rdt) @ params["router"].to(rdt)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)  # (T, k), largest first
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = eidx.reshape(-1)  # (T*k,), token-major
    # tokens per expert as a comparison sum: `bincount` reads its input's
    # max back to the host on the card, a sync in every decode step
    counts = (flat_e[:, None] == torch.arange(E, device=dev)).sum(0)
    density = counts.to(torch.float32) / (T * k)
    aux = E * torch.sum(density * probs.mean(0)) * cfg.router_aux_weight

    # rank of each (token, slot) within its expert's queue, in token order
    if rows is None:
        rank = _queue_rank(flat_e, E)
        C = _capacity(T, cfg)
    else:
        rank = _queue_rank(rows.gather(flat_e), E)[rows.rank * T * k:(rows.rank + 1) * T * k]
        C = _capacity(T * rows.size, cfg)
    keep = rank < C
    e_loc = params["experts_gate"].shape[0]
    if tp is not None:
        tp.count_moe(e_loc)
    # replicated experts (E does not divide by T) run whole on every rank,
    # with nothing summed
    out = _own_experts(params, xt, gate, flat_e, rank, keep, C, tp if e_loc < E else None, B)
    out = out.reshape(B, -1, d)
    if seq and e_loc == E:
        out = tp.split(out, 1)
    return out, aux

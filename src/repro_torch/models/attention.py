"""GQA attention: full, blocked (online softmax), flash, and decode.

Port of `repro.models.attention`: `init_attention` (no QKV bias on a
cross layer), `_proj_qkv` (keys and values from a separate ``kv_x``),
`_sdpa_grouped` and `full_attention` (causal, with the optional
`sliding_window` mask, or ``cross``: no RoPE and every key visible);
the long-sequence paths `blocked_attention` (its own online softmax over
kv blocks, each step checkpointed) and `flash_self_attention` (through
`repro_torch.models.flash`, what `apply_model` takes at S >= 8192); and
the decode path: `KVCache`, `decode_attention` and
`cross_decode_attention`.

Shapes: activations (B, S, d); heads (B, S, H, hd). KV caches:

  - full cache: k/v (B, C, Hkv, hd), the token at ``pos`` written to
    slot ``min(pos, C - 1)``;
  - ring cache: k/v (B, W, Hkv, hd), W = the sliding window, slot
    ``pos % W`` (O(W) memory: dense models at long_500k).

The port writes a decode step's keys and values into the cache in place
(``index_copy_`` at a slot computed on the device from the 0-d ``pos``
tensor), so a step copies no cache and reads nothing back to the host.

Tensor parallelism (`repro_torch.sharding.tp`). Given a `TP`, every
attention path (self-attention, and the vlm's cross attention, whose
keys and values come from the patch embeddings) runs on the rank's share
of the query heads (`_layout`, `rank_heads`), on one of two routes:

  - heads (Megatron): ``wq`` is sharded at whole heads, and the rank
    multiplies its block;
  - padded: ``wq``'s shard cuts a head. ``wq`` and ``wo`` are gathered
    (`TP.gather_partial`: the gradient is reduce-scattered back) and the
    rank slices out its ceil(H / T) heads' columns and rows, the
    reference's padded split: the last ranks take fewer heads, or none
    (a rank without heads still joins every collective, its output and
    gradients zero).

On both, the input goes through `TP.copy`, the rank computes its query
heads against the kv heads they read, and ``wo``'s rows finish with
`TP.reduce`. Under sequence parallelism the input is the rank's
positions, gathered along the sequence (`TP.gather_seq`), the output
reduce-scattered back to them (`TP.scatter_seq`), RoPE at the whole
sequence's positions; a cross layer's keys and values still come from
the whole patch embeddings, through `TP.copy`. A layer whose ``wq``
stays whole runs alike on every rank on the gathered sequence
(`TP.gather`) and keeps its positions (`TP.split`). The kv heads are the rank's own block where ``wk``'s
shard is whole heads; else the rank slices the ones its query heads
read out of ``wk`` and ``wv``, gathered (`TP.gather_partial`) where
their shard cuts a head and through `TP.copy` where they are
replicated, and its query heads pick theirs from them. The QKV biases
are replicated in storage, and each rank adds its slice of them through
`TP.copy`, so their gradients are summed over the ranks.

A decode cache holds the kv heads the rank computes (`rank_heads`), and
so do a cross layer's static K/V (`rank_kv_weights`); at decode the cross
layer multiplies only its query and output projections (``_layout(kv=False)``).
A serve step's `repro_torch.sharding.tp.CacheLayout` lays the cache
otherwise (`decode_attention`): the rank's block of its slots (over
"data" or "model"), each rank's partial softmax merged with the others',
or every kv head at the rank's block of head_dim, the partial scores
summed.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg, cross: bool = False):
    """``{wq (d, Hq*hd), wk, wv (d, Hkv*hd), wo (Hq*hd, d)}`` plus zero
    ``bq, bk, bv`` when ``cfg.qkv_bias`` and not `cross`, in
    ``cfg.dtype``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dtype = cfg.torch_dtype
    p = {
        "wq": dense_init(generator, (d, nq * hd), d, dtype),
        "wk": dense_init(generator, (d, nkv * hd), d, dtype),
        "wv": dense_init(generator, (d, nkv * hd), d, dtype),
        "wo": dense_init(generator, (nq * hd, d), nq * hd, dtype),
    }
    if cfg.qkv_bias and not cross:
        dev = generator.device
        p["bq"] = torch.zeros((nq * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dtype, device=dev)
    return p


def _split_heads(x, n_heads, hd):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def _same(x):
    return x


class Layout(NamedTuple):
    """How one rank computes an attention layer: ``params`` are the
    projections as it multiplies them, ``hq`` and ``hkv`` the query and
    kv heads it computes (and caches), ``pick`` selects from those kv
    heads the ones its query heads read, ``n_rep`` query heads to each
    picked kv head; ``x_op`` goes on the input, ``kv_op`` on a separate
    input of the keys and values (a cross layer's patch embeddings),
    ``out_op`` on the output product."""
    params: dict
    hq: int
    hkv: int
    pick: Callable
    n_rep: int
    x_op: Callable
    kv_op: Callable
    out_op: Callable


def rank_heads(cfg, rank: int, size: int, q_sharded: bool = True,
               kv_whole_heads: bool = False):
    """``(q0, hq, k0, hkv)``: the query heads ``q0 .. q0 + hq`` that model
    rank `rank` of `size` computes, and the kv heads ``k0 .. k0 + hkv``
    it computes (and caches) for them. Without `q_sharded` (``wq``'s
    columns do not divide by `size`) the rank computes every head. Else
    it takes ``c = ceil(H / size)`` query heads from ``rank * c`` on, as
    GSPMD pads a head axis that does not divide: the last ranks may take
    fewer or none. With `kv_whole_heads` (``wk``'s columns split at whole
    heads, so the query heads split evenly too) the kv heads are the
    rank's own block; else the ones its query heads read."""
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    if not q_sharded:
        return 0, nq, 0, nkv
    n_rep = nq // nkv
    if kv_whole_heads:
        hkv = nkv // size
        return rank * hkv * n_rep, hkv * n_rep, rank * hkv, hkv
    c = -(-nq // size)
    q0 = min(rank * c, nq)
    hq = min(c, nq - q0)
    k0 = q0 // n_rep
    return q0, hq, k0, -(-(q0 + hq) // n_rep) - k0 if hq else 0


def _pick_kv(q0: int, hq: int, k0: int, n_rep: int):
    """For query heads ``q0 .. q0 + hq`` reading kv heads from ``k0`` on:
    a pick of each one's kv head (the kv axis becomes the query heads')."""
    def pick(t):
        idx = torch.div(torch.arange(q0, q0 + hq, device=t.device), n_rep,
                        rounding_mode="floor") - k0
        return t.index_select(-2, idx)

    return pick


def _rank_kv(params, cfg, tp, ks, kv_own: bool):
    """The rank's kv projections, columns `ks` of the kv heads (see the
    module docstring), and how many leaves it gathered."""
    p, gathered = {}, 0
    kv_sharded = params["wk"].shape[-1] < cfg.num_kv_heads * cfg.resolved_head_dim
    for name in ("wk", "wv"):
        if kv_own:
            p[name] = params[name]
        elif kv_sharded:  # cut inside a head: gathered, the rank's kv heads sliced
            p[name] = tp.gather_partial(params[name])[..., ks]
            gathered += 1
        else:  # replicated
            p[name] = tp.copy(params[name])[..., ks]
    if "bk" in params:
        p["bk"], p["bv"] = tp.copy(params["bk"])[ks], tp.copy(params["bv"])[ks]
    return p, gathered


def _rank_split(params, cfg, tp):
    """``(q0, hq, k0, hkv, kv_own)`` of `rank_heads` for the rank of `tp`
    (``kv_own``: ``wk``'s shard is whole heads), or None where the rank
    computes the whole layer (no `tp`, or ``wq`` not sharded)."""
    if tp is None or params["wq"].shape[-1] == cfg.num_heads * cfg.resolved_head_dim:
        return None  # kv columns divide only where q's do
    kv_own = _kv_own(params, cfg)
    return (*rank_heads(cfg, tp.rank, tp.size, True, kv_own), kv_own)


def _kv_own(params, cfg) -> bool:
    """Whether ``wk``'s shard is whole kv heads (the rank's own block)."""
    hd = cfg.resolved_head_dim
    kv_cols = params["wk"].shape[-1]
    return kv_cols < cfg.num_kv_heads * hd and kv_cols % hd == 0


def rank_kv_weights(params, cfg, tp=None):
    """``(wk, wv, hkv)``: the kv projections of the ``hkv`` kv heads that
    the rank of `tp` computes in the attention layer `params`, by
    `_layout`'s rule (its own block where ``wk``'s shard is whole heads,
    else the ones its query heads read), whole without `tp`."""
    split = _rank_split(params, cfg, tp)
    if split is None:
        return params["wk"], params["wv"], cfg.num_kv_heads
    _, _, k0, hkv, kv_own = split
    hd = cfg.resolved_head_dim
    p, _ = _rank_kv(params, cfg, tp, slice(k0 * hd, (k0 + hkv) * hd), kv_own)
    return p["wk"], p["wv"], hkv


def _layout(params, cfg, tp=None, kv: bool = True) -> Layout:
    """The rank's `Layout` of one attention layer (see the module
    docstring); the whole layer without `tp` or when nothing is sharded.
    Without `kv` its params hold no kv projections (a cross layer at
    decode reads cached keys and values)."""
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    n_rep = nq // nkv
    split = _rank_split(params, cfg, tp)
    if split is None:
        if tp is not None and tp.seq:  # the whole layer alike on every rank, whole sequence
            return Layout(params, nq, nkv, _same, n_rep, lambda x: tp.gather(x, 1), _same,
                          tp.split)
        return Layout(params, nq, nkv, _same, n_rep, _same, _same, _same)
    q0, hq, k0, hkv, kv_own = split
    qs, ks = slice(q0 * hd, (q0 + hq) * hd), slice(k0 * hd, (k0 + hkv) * hd)
    gathered = 0
    if params["wq"].shape[-1] % hd:  # a shard cuts a query head: the padded route
        p = {"wq": tp.gather_partial(params["wq"])[..., qs],
             "wo": tp.gather_partial(params["wo"], dim=-2)[..., qs, :]}
        route, gathered = "padded", 2
    else:
        p = {"wq": params["wq"], "wo": params["wo"]}
        route = "heads"
    if "bq" in params:
        p["bq"] = tp.copy(params["bq"])[qs]
    if kv:
        kv_p, n = _rank_kv(params, cfg, tp, ks, kv_own)
        p.update(kv_p)
        gathered += n
    tp.count(route, gathered)
    if kv_own or (q0 % n_rep == 0 and hq % n_rep == 0):
        return Layout(p, hq, hkv, _same, n_rep, tp.enter, tp.copy, tp.leave)
    return Layout(p, hq, hkv, _pick_kv(q0, hq, k0, n_rep), 1, tp.enter, tp.copy, tp.leave)


def _proj_qkv(params, x, kv_x, cfg, lay=None):
    """q, k, v split into heads: (..., hq, hd), (..., hkv, hd) of the
    `Layout` `lay` (the whole layer by default)."""
    lay = _layout(params, cfg) if lay is None else lay
    p, hd = lay.params, cfg.resolved_head_dim
    same = kv_x is x
    x = lay.x_op(x)
    kv_x = x if same else lay.kv_op(kv_x)
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        _split_heads(q, lay.hq, hd),
        _split_heads(k, lay.hkv, hd),
        _split_heads(v, lay.hkv, hd),
    )


def _repeat_kv(k, n_rep: int):
    """(B, T, Hkv, hd) -> (B, T, Hkv * n_rep, hd): head h reads kv head
    ``h // n_rep`` (``jnp.repeat`` along the head axis)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=-2)


def _wide(dtype):
    """The scores' dtype: f32, f64 for an f64 model."""
    return torch.promote_types(dtype, torch.float32)


def _sdpa(q, k, v, mask):
    """q (B, S, H, hd), k/v (B, T, H, hd); mask broadcastable to
    (B, 1, S, T). Scores and softmax in f32 (f64 for an f64 model),
    probabilities cast to ``v.dtype``."""
    hd = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(_wide(q.dtype))
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_grouped(q, k, v, mask, n_rep: int):
    """GQA attention without materializing the repeated K/V.

    q (B, S, Hq, hd) with Hq = Hkv * n_rep, so query head h reads KV head
    ``h // n_rep``; k/v (B, T, Hkv, hd); mask (1, 1, S, T) bool. Scores
    and softmax in f32 (masked with -1e30; f64 for an f64 model, as
    `apply_rope` and the norms: then the scores' rounding does not hang on
    how many heads one softmax call holds, so f64 stays an exact witness
    of a layout), probabilities cast to ``v.dtype`` before the value
    product."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, n_rep, hd)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).to(_wide(q.dtype))
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v)
    return out.reshape(B, S, Hq, hd)


def causal_mask(S: int, T: int, sliding_window: int = 0, device=None) -> torch.Tensor:
    """(1, 1, S, T) bool: key j visible from query i iff j <= i (and
    j > i - sliding_window when the window is on)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    mask = j <= i
    if sliding_window > 0:
        mask = mask & (j > i - sliding_window)
    return mask[None, None]


def full_attention(params, x: torch.Tensor, cfg, positions=None,
                   kv_x=None, cross: bool = False,
                   sliding_window: int = 0, tp=None) -> torch.Tensor:
    """Causal self-attention (RoPE at `positions`, default ``0..S-1``),
    or with `cross` attention to every row of `kv_x` without RoPE; scores
    fully materialized. x (B, S, d), kv_x (B, T, d) -> (B, S, d). `tp`:
    the rank's share (see the module docstring; under sequence
    parallelism x is the rank's positions and the default `positions`
    those of the whole sequence)."""
    B = x.shape[0]
    lay = _layout(params, cfg, tp)
    q, k, v = _proj_qkv(params, x, kv_x if kv_x is not None else x, cfg, lay)
    S, T = q.shape[1], k.shape[1]
    if cross:
        mask = torch.ones((1, 1, S, T), dtype=torch.bool, device=x.device)
    else:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        mask = causal_mask(S, T, sliding_window, device=x.device)
    out = _sdpa_grouped(q, lay.pick(k), lay.pick(v), mask, lay.n_rep)
    return lay.out_op(out.reshape(B, S, -1) @ lay.params["wo"])


def _rope_qkv(params, x, cfg, lay):
    """Self-attention q, k, v at positions 0..S-1 with the kv heads
    repeated to the query heads: three (B, S, H, hd) tensors, H the
    `Layout`'s query heads, S the whole sequence's."""
    q, k, v = _proj_qkv(params, x, x, cfg, lay)
    positions = torch.arange(q.shape[1], device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, _repeat_kv(lay.pick(k), lay.n_rep), _repeat_kv(lay.pick(v), lay.n_rep)


def _blocked_kv_step(acc, m, l, q, k_j, v_j, mask, hd: int):
    """One kv block of `blocked_attention`'s online softmax over every q
    block at once: q (B, n_q, bq, H, hd), k_j/v_j (B, bk, H, hd), mask
    (n_q, bq, bk); acc (B, n_q, H, bq, hd), m/l (B, n_q, H, bq) f32."""
    s = torch.einsum("bnqhd,bkhd->bnhqk", q, k_j).to(torch.float32)
    s = s / math.sqrt(hd)
    s = torch.where(mask[None, :, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bnhqk,bkhd->bnhqd", p.to(v_j.dtype), v_j).to(torch.float32)
    return acc, m_new, l_new


def blocked_attention(params, x, cfg, block_q: int = 512, block_kv: int = 1024,
                      sliding_window: int = 0, remat_steps: bool = True, tp=None):
    """Causal self-attention with an online softmax over kv blocks.

    O(S * block_kv) score memory. The reference maps over q blocks and
    scans the kv blocks inside; here the q blocks are a tensor axis (each
    q block sees the kv blocks in the same order, so its sums are the
    reference's) and the loop runs over every kv block, as the
    reference's scan does. ``remat_steps`` checkpoints each kv step, so
    the backward recomputes the block probabilities instead of saving
    them (the reference's ``jax.checkpoint`` of the step). `tp`: the
    rank's share (see the module docstring)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    lay = _layout(params, cfg, tp)
    H = lay.hq
    q, k, v = _rope_qkv(params, x, cfg, lay)
    S = q.shape[1]
    n_q, n_kv = S // block_q, S // block_kv
    qb = q.reshape(B, n_q, block_q, H, hd)
    f32 = torch.float32
    acc = torch.zeros((B, n_q, H, block_q, hd), dtype=f32, device=x.device)
    m = torch.full((B, n_q, H, block_q), NEG_INF, dtype=f32, device=x.device)
    l = torch.zeros((B, n_q, H, block_q), dtype=f32, device=x.device)
    iq = torch.arange(S, device=x.device).reshape(n_q, block_q, 1)
    for j in range(n_kv):
        jk = (j * block_kv + torch.arange(block_kv, device=x.device)).reshape(1, 1, -1)
        mask = jk <= iq
        if sliding_window > 0:
            mask = mask & (jk > iq - sliding_window)
        k_j = k[:, j * block_kv:(j + 1) * block_kv]
        v_j = v[:, j * block_kv:(j + 1) * block_kv]
        if remat_steps and torch.is_grad_enabled():
            acc, m, l = checkpoint(_blocked_kv_step, acc, m, l, qb, k_j, v_j, mask, hd,
                                   use_reentrant=False)
        else:
            acc, m, l = _blocked_kv_step(acc, m, l, qb, k_j, v_j, mask, hd)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = torch.einsum("bnhqd->bnqhd", out).to(x.dtype)
    return lay.out_op(out.reshape(B, S, H * hd) @ lay.params["wo"])


def flash_self_attention(params, x, cfg, sliding_window: int = 0,
                         block_q: int = 512, block_kv: int = 512, tp=None):
    """Causal self-attention through `flash.flash_attention` (O(S)
    residual memory: the trainable long-sequence path), blocks
    ``min(block, S)``; `tp` as in `full_attention`."""
    from repro_torch.models.flash import flash_attention

    B = x.shape[0]
    lay = _layout(params, cfg, tp)
    q, k, v = _rope_qkv(params, x, cfg, lay)
    S = q.shape[1]
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          min(block_q, S), min(block_kv, S), sliding_window)
    return lay.out_op(out.transpose(1, 2).reshape(B, S, -1) @ lay.params["wo"])


# ---------------------------------------------------------------------------
# Decode with a KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, Hkv, hd); Hkv the rank's kv heads under tensor parallelism
    v: torch.Tensor
    # a ring when C == the sliding window: slot = pos % C

    @staticmethod
    def init(batch, cache_len, n_kv, hd, dtype, device=None, lead=()):
        """Zero k and v, two tensors (the port writes into them), with the
        leading axes `lead` (a model's stacked groups) before the batch."""
        shape = (*lead, batch, cache_len, n_kv, hd)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def _rank_splits(params, cfg, tp):
    """`rank_heads` of every model rank of `tp` under the layer's route
    (`_rank_split`'s rule): ``[(q0, hq, k0, hkv), ...]`` in rank order."""
    kv_own = _kv_own(params, cfg)
    return [rank_heads(cfg, r, tp.size, True, kv_own) for r in range(tp.size)]


def _every_head(q, k, v, cfg, tp, splits, memo):
    """The decode step's q (B, 1, hq, hd), k and v (B, 1, hkv, hd) of the
    rank's heads (RoPE applied) -> every query head's and every kv head's,
    (B, 1, H, hd) and (B, 1, Hkv, hd): each rank's heads padded to the
    largest share, the three packed and gathered over the model ranks in
    one collective, each head taken from the first rank that computes it
    (a rank without heads sends padding only). `memo` keeps the head
    indices on each device."""
    cq = max(hq for _, hq, _, _ in splits)
    ck = max(hkv for _, _, _, hkv in splits)
    w = cq + 2 * ck

    def pad(t, n):
        return torch.cat([t, t.new_zeros(*t.shape[:2], n - t.shape[2], t.shape[3])], dim=2)

    packed = torch.cat([pad(q, cq), pad(k, ck), pad(v, ck)], dim=2)
    got = tp.mesh.model_all_gather(packed, dim=2)
    iq, ik = [], []
    for h in range(cfg.num_heads):
        r = next(r for r, (q0, hq, _, _) in enumerate(splits) if q0 <= h < q0 + hq)
        iq.append(r * w + h - splits[r][0])
    for g in range(cfg.num_kv_heads):
        r = next(r for r, (_, _, k0, hkv) in enumerate(splits) if k0 <= g < k0 + hkv)
        ik.append(r * w + cq + g - splits[r][2])
    ik = _index(memo, ik, q.device)
    return (got.index_select(2, _index(memo, iq, q.device)), got.index_select(2, ik),
            got.index_select(2, ik + ck))


def _index(memo, values, device) -> torch.Tensor:
    """A static index list as a tensor on `device`, made once and kept in
    `memo` (a copy from the host on each step would be a host sync on the
    card)."""
    key = (tuple(values), str(device))
    if key not in memo:
        memo[key] = torch.tensor(values, dtype=torch.long, device=device)
    return memo[key]


def _sum_scores(scores, mesh):
    """The partial scores of the rank's block of head_dim summed over the
    model ranks, in their dtype (f32, f64 for an f64 model)."""
    return mesh.model_all_reduce(scores)


def _rescale(m_loc, m):
    """A rank's partial softmax taken from its own row max `m_loc` to the
    row max `m` over every slot: exactly 0 where every slot of the rank is
    masked (``exp(-1e30 - m)``)."""
    return torch.exp(m_loc - m)


def _cached_attention(q, k, v, valid, n_rep: int, hd: int, layout=None):
    """One query position against cached keys and values whose slots or
    head_dim a `layout` (`repro_torch.sharding.tp.CacheLayout`) splits:
    q (B, 1, Hq, hd_loc), k/v (B, C_loc, Hkv, hd_loc), valid (C_loc,) the
    rank's slots that hold a token; `hd` the whole head_dim (the scale).
    As `_sdpa_grouped`, the scores in f32 (f64 for an f64 model). A split
    head_dim sums the partial scores over the model ranks. Split slots
    run a partial softmax on each rank (its row max ``m``, the sum ``l``
    of its exponentials, the weighted values ``o``), merged over the
    ranks that hold the other slots: the row max, each rank's ``l`` and
    ``o`` rescaled to it (`_rescale`), summed, ``o / l``. Returns the
    output (B, 1, Hq, hd_loc) in ``v.dtype``."""
    B, S, Hq, d = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, n_rep, d)
    wide = _wide(q.dtype)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).to(wide)
    if layout is not None and layout.head_dim:
        scores = _sum_scores(scores, layout.mesh)
    scores = torch.where(valid, scores / math.sqrt(hd), NEG_INF)
    if layout is None or layout.slots is None:
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bgrst,btgd->bsgrd", probs, v).reshape(B, S, Hq, d)
    m_loc = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m_loc)
    o = torch.einsum("bgrst,btgd->bgrsd", p.to(v.dtype), v).to(wide)
    scale = _rescale(m_loc, layout.slot_reduce(m_loc, "max"))
    lo = layout.slot_reduce(torch.cat([o * scale, p.sum(-1, keepdim=True) * scale], -1), "sum")
    out = (lo[..., :-1] / lo[..., -1:]).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, d)


def _write_slot(cache_t, new, slot, layout):
    """`new` (B, 1, H, hd_loc) into `cache_t` (B, C_loc, H, hd_loc) at the
    global `slot` (a 0-d tensor) when this rank holds it, in place; the
    rank's slots a block of ``C_loc`` (`CacheLayout.slot_block`)."""
    index, parts = (0, 1) if layout is None else layout.slot_block()
    new = new.to(cache_t.dtype)
    if parts == 1:
        cache_t.index_copy_(1, slot.reshape(1).long(), new)
        return
    c_loc = cache_t.shape[1]
    local = slot.reshape(1).long() - index * c_loc
    own = (local >= 0) & (local < c_loc)
    at = torch.clamp(local, 0, c_loc - 1)
    cache_t.index_copy_(1, at, torch.where(own, new, cache_t.index_select(1, at)))


def decode_attention(params, x, cache: KVCache, pos, cfg, ring: bool = False, tp=None,
                     layout=None):
    """One-token decode. x (B, 1, d); pos a 0-d integer tensor (the
    current position). Returns ``(out (B, 1, d), cache)``: this token's
    key and value written into `cache` in place, at slot ``pos % C`` on a
    ring (sliding-window attention, O(C) a token) and ``min(pos, C - 1)``
    otherwise, C the whole cache's slots. `tp` as in `full_attention`; the
    cache holds the kv heads of the rank's `Layout`, unless `layout` (a
    `repro_torch.sharding.tp.CacheLayout`) says otherwise:

      - its slots split over "data" or "model": the rank writes the slot
        when it holds it, and its partial softmax over its slots merges
        with the other ranks' (`_cached_attention`);
      - every kv head (``every_head``), whole or at the rank's block of
        head_dim: RoPE at whole heads under the rank's route, then q, k
        and v relaid to every head (`_every_head`); the attention of every
        head, brought back to the rank's own heads (its head_dim block
        gathered over the model ranks first) before ``wo``."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = torch.as_tensor(pos, device=x.device)
    lay = _layout(params, cfg, tp)
    q, k, v = _proj_qkv(params, x, x, cfg, lay)
    pos_arr = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)

    index, parts = (0, 1) if layout is None else layout.slot_block()
    c_loc = cache.k.shape[1]
    C = c_loc * parts
    slot = torch.remainder(pos, C) if ring else torch.clamp(pos, max=C - 1)
    every = layout is not None and layout.every_head and lay.hq < cfg.num_heads
    q0 = 0
    if every:
        splits = _rank_splits(params, cfg, tp)
        q0 = splits[tp.rank][0]
        q, k, v = _every_head(q, k, v, cfg, tp, splits, layout.memo)
    if layout is not None and layout.head_dim:
        b, n = layout.hd_block()
        blk = slice(b * hd // n, (b + 1) * hd // n)
        q, k, v = q[..., blk], k[..., blk], v[..., blk]
    _write_slot(cache.k, k, slot, layout)
    _write_slot(cache.v, v, slot, layout)

    idx = index * c_loc + torch.arange(c_loc, device=x.device)
    if ring:
        valid = (idx <= slot) | (pos >= C)  # the whole ring once wrapped
    else:
        valid = idx <= pos
    if layout is not None and layout.every_head:
        kk, vv, n_rep = cache.k, cache.v, cfg.num_heads // cfg.num_kv_heads
    else:
        kk, vv, n_rep = lay.pick(cache.k), lay.pick(cache.v), lay.n_rep
    if layout is None:
        out = _sdpa_grouped(q, kk, vv, valid[None, None, None, :], n_rep)
    else:
        out = _cached_attention(q, kk, vv, valid, n_rep, hd, layout)
        if layout.head_dim:
            out = layout.mesh.model_all_gather(out, dim=-1)
        if every:
            out = out[:, :, q0:q0 + lay.hq]
    return lay.out_op(out.reshape(B, 1, -1) @ lay.params["wo"]), cache


def cross_decode_attention(params, x, k_cache, v_cache, cfg, tp=None):
    """Cross-attention at decode: x (B, 1, d) against the static K/V of
    the patch tokens, k_cache/v_cache (B, P, Hkv, hd). `tp`: the rank's
    query heads and ``wo`` rows (`_layout`) against the kv heads it holds
    (`repro_torch.models.model.init_cross_kv` with the mesh)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    lay = _layout(params, cfg, tp, kv=False)
    q = _split_heads(lay.x_op(x) @ lay.params["wq"], lay.hq, hd)
    kk = _repeat_kv(lay.pick(k_cache), lay.n_rep)
    vv = _repeat_kv(lay.pick(v_cache), lay.n_rep)
    mask = torch.ones((1, 1, 1, kk.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, kk, vv, mask)
    return lay.out_op(out.reshape(B, 1, -1) @ lay.params["wo"])

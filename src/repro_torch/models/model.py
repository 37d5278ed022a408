"""The unified decoder, every family of the reference.

Port of `repro.models.model` for the training path. A model is a
repeating *pattern* of sub-blocks over ``n_groups``:

  dense/audio : ['attn', 'mlp']                          x L
  moe         : ['attn', 'moe']                          x L
  ssm         : ['ssm']                                  x L
  hybrid      : ['ssm'] * k + ['shared']                 x L / k  (zamba2)
  vlm         : ['attn', 'mlp'] * (k - 1) + ['cross', 'mlp']  x L / k

'shared' is one weight-shared attention + MLP block (``params["shared"]``,
applied once per group, Zamba2-style); its sub-block in the group is the
empty ``{}`` of the reference, which the port's tree helpers drop, so it
reads nothing from the group. 'cross' attends to the batch's patch
embeddings (``batch["cross_embeds"]``) behind a tanh gate (a 0-d leaf per
group). An audio model reads frame embeddings (``batch["embeds"]``) in
place of tokens and its labels from ``batch["labels"]``.

The parameters keep the reference's **stacked** layout: every leaf of
``params["groups"]`` has a leading group axis (L, ...), under the keys
``"<i>:<kind>"``, so the flat plane of a parameter dict matches the JAX
ravel column for column. The reference's ``lax.scan`` over groups is a
loop over ``g`` here, and its ``jax.checkpoint`` (``cfg.remat``) is
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, with the
shared block's weights passed in as inputs. Its ``sharding.axes.constrain``
calls only place activations on a device mesh and do nothing on one
device, so they are left out.

At ``S >= blocked_attn_threshold`` (8192) the self-attention of every
family but ssm takes the flash path (`attention.flash_self_attention`);
cross-attention stays full. `lm_loss` with ``vocab_chunk > 0`` never
holds the (B, S, V) logits: it runs the sequence in chunks of
`vocab_chunk` positions, each under a checkpoint.

Decode (`DecodeState`, `init_decode_state`, `init_cross_kv`,
`decode_step`): one token against per-group stacked caches, a `KVCache`
per attention sub-block (a ring of ``sliding_window`` slots when the
context is longer than the window) and an `SSMState` per Mamba2 block.
`decode_step` writes each group's caches in place, so a step copies no
cache, and keeps ``pos`` a 0-d tensor on the device, so it reads nothing
back to the host.

Tensor parallelism. Under a `repro_torch.sharding.tp.use` context (the
steps of `repro_torch.launch.steps` set it on a mesh whose "model" axis
is larger than 1) every family runs on the rank's blocks of its leaves:
attention on its heads (`attention.Layout`; the hybrid's shared block
and the vlm's cross layers too, whose 0-d tanh gate is replicated and
multiplies the layer's output after its reduce, so its gradient is
whole on every rank), the MLP on its
``d_ff`` block, a moe layer on its experts (`moe.moe_block`), a Mamba2
block on its ssm heads (`ssm.ssm_block`), the embedding on its rows of
the vocabulary (ids outside them masked, looked up, then summed over the
ranks), the head into its block of the logits, and `lm_loss` through the
vocab-parallel cross-entropy (`layers.token_nll`). `apply_model` and
`decode_step` then return the rank's vocabulary block of the logits. An
audio model reads its frame embeddings whole on every model rank; its
token embedding, which the loss never reads, is still split by rows, so
a serving loop that feeds back a token's embedding looks it up
vocab-parallel (`token_embeds`).

Sequence parallelism (a context with ``seq``, the train step's
``seq_parallel=True``). The residual stream between the sub-blocks, and
so a layer group's checkpointed carry, is the rank's S / T positions:
the embedding ends in a reduce-scatter along the sequence (a whole
table, or an audio model's frame embeddings, read at the rank's
positions), every sharded layer gathers the sequence on its way in and
reduce-scatters it on its way out (`TP.enter`, `TP.leave`), a moe layer
routes the whole gathered sequence (`moe.moe_block`), the norms run on
the rank's positions with their scales through `TP.copy` (`_rep`; so
do the cross layer's gate and any replicated MLP), and the head
gathers the sequence back (`_head_input`). The numbers are those
without the flag; only where the data sits, and the memory it takes,
change. Where the model axis does not divide S the residual stays
whole, and the tally says so (`TP.count_seq`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import as_generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import flat as flat_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (cross_entropy, dense_init, init_mlp, mlp, rms_norm,
                                       token_nll)
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.ssm import (SSMState, init_ssm, rank_ssm_heads, ssm_block,
                                   ssm_decode_step)
from repro_torch.sharding import tp as tp_lib


def block_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int]:
    """(sub-block kinds of one group, number of groups)."""
    if cfg.family in ("dense", "audio"):
        return ("attn", "mlp"), cfg.num_layers
    if cfg.family == "moe":
        return ("attn", "moe"), cfg.num_layers
    if cfg.family == "ssm":
        return ("ssm",), cfg.num_layers
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        if cfg.num_layers % k:
            raise ValueError(f"{cfg.num_layers} layers are not groups of {k}")
        return tuple(["ssm"] * k + ["shared"]), cfg.num_layers // k
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        if cfg.num_layers % k:
            raise ValueError(f"{cfg.num_layers} layers are not groups of {k}")
        return tuple(["attn", "mlp"] * (k - 1) + ["cross", "mlp"]), cfg.num_layers // k
    raise ValueError(f"unknown model family {cfg.family!r}")


def init_params(key, cfg: ModelConfig, device=None, shard=None) -> Dict[str, Any]:
    """Single-client parameters: ``{embed (V, d), final_norm (d,),
    groups {"0:attn": ..., "1:mlp": ...} with (n_groups, ...) leaves}``
    plus ``lm_head (d, V)`` when embeddings are untied and ``shared``
    (the hybrid's shared block), in ``cfg.dtype``.

    `key` is an int seed or a `torch.Generator` (see `as_generator`);
    the draws differ from the reference's threefry ones, the layout and
    scales do not. `shard(path, leaf) -> leaf` replaces each leaf as it
    is drawn (each layer group's slice before the groups are stacked),
    so that a rank keeps its block of every leaf without ever holding the
    whole model (`repro_torch.sharding.tp.shard_leaf`); the draws are
    the same."""
    gen = as_generator(key, device)
    pattern, n_groups = block_pattern(cfg)
    dtype = cfg.torch_dtype
    d = cfg.d_model
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def init_group():
        gp = {}
        for i, kind in enumerate(pattern):
            name = f"{i}:{kind}"
            if kind == "attn":
                gp[name] = {"norm": zeros(d),
                            "attn": attn_lib.init_attention(gen, cfg)}
            elif kind == "cross":
                gp[name] = {"norm": zeros(d),
                            "attn": attn_lib.init_attention(gen, cfg, cross=True),
                            "gate": zeros()}  # llama3.2-vision's tanh gate
            elif kind == "mlp":
                gp[name] = {"norm": zeros(d),
                            "mlp": init_mlp(gen, d, cfg.d_ff, dtype)}
            elif kind == "moe":
                gp[name] = {"norm": zeros(d), "moe": init_moe(gen, cfg)}
            elif kind == "ssm":
                gp[name] = {"norm": zeros(d), "ssm": init_ssm(gen, cfg)}
            elif kind == "shared":
                gp[name] = {}  # the weights live in params["shared"]
        return gp

    def kept(prefix, tree):
        if shard is None:
            return tree
        return flat_lib.tree_from_items((prefix + path, shard(prefix + path, leaf))
                                        for path, leaf in flat_lib.tree_items(tree))[prefix[0]]

    per_group = [kept(("groups",), init_group()) for _ in range(n_groups)]
    groups = _stack_groups(per_group)
    params = {
        "embed": kept(("embed",), dense_init(gen, (cfg.vocab_size, d), d, dtype)),
        "groups": groups,
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = kept(("lm_head",), dense_init(gen, (d, cfg.vocab_size), d, dtype))
    if cfg.family == "hybrid":
        params["shared"] = kept(("shared",), {
            "norm_attn": zeros(d),
            "attn": attn_lib.init_attention(gen, cfg),
            "norm_mlp": zeros(d),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype),
        })
    return params


def _stack_groups(per_group):
    if isinstance(per_group[0], dict):
        return {k: _stack_groups([g[k] for g in per_group]) for k in per_group[0]}
    return torch.stack(per_group)


def _unbind_groups(groups, n_groups: int):
    """Per-group views of the stacked (L, ...) leaves, one `unbind` per
    leaf. Its backward stacks the L slice gradients once; indexing
    ``leaf[g]`` per group instead would scatter each slice gradient into
    a zeroed (L, ...) tensor and sum the L of them (bytes growing as L^2;
    measured 0.38 s per step at qwen2-1.5b width, 4 clients)."""
    if isinstance(groups, dict):
        per_key = {k: _unbind_groups(v, n_groups) for k, v in groups.items()}
        return [{k: per_key[k][g] for k in groups} for g in range(n_groups)]
    return groups.unbind(0)


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _vocab_tp(params, cfg, tp):
    """`tp` when the head holds the rank's block of the vocabulary, else None."""
    return tp if tp is not None and _head(params, cfg).shape[-1] < cfg.vocab_size else None


def _rep(leaf, tp):
    """A replicated leaf as the rank reads it (`TP.shared`: through
    `TP.copy` under sequence parallelism, where the rank reads it on its
    positions alone)."""
    return leaf if tp is None else tp.shared(leaf)


def _final_norm(params, cfg, h, tp=None):
    return rms_norm(h, _rep(params["final_norm"], tp), cfg.norm_eps)


def _head_input(params, cfg, x, tp=None):
    """The final-normed hidden states `x` as the head multiplies them: with
    a vocab-parallel head through `TP.copy` (each rank's gradient is its
    vocabulary block's part); under sequence parallelism the rank's
    positions gathered along the sequence, by `TP.gather_seq` for a
    vocab-parallel head (the same partial gradients, summed and scattered
    back) and by `TP.gather` for a whole head on every rank (its loss and
    gradient alike on every rank, each keeping its positions')."""
    vtp = _vocab_tp(params, cfg, tp)
    if tp is not None and tp.seq:
        return tp.gather(x, 1) if vtp is None else tp.gather_seq(x)
    return x if vtp is None else vtp.copy(x)


def _logits(params, cfg, h, tp=None):
    """The head's logits: the rank's vocabulary block when it is sharded."""
    return _head_input(params, cfg, _final_norm(params, cfg, h, tp), tp) @ _head(params, cfg)


def _ff_tp(mp, cfg, tp):
    """`tp` when the MLP's params `mp` are the rank's ``d_ff`` block."""
    return tp if tp is not None and mp["w_gate"].shape[-1] < cfg.d_ff else None


def _mlp(mp, x, cfg, tp):
    """The MLP of params `mp` on `x`: on the rank's ``d_ff`` block, or
    whole (a position-wise layer: under sequence parallelism on the
    rank's positions, its replicated leaves through `_rep`)."""
    ftp = _ff_tp(mp, cfg, tp)
    if ftp is None and tp is not None:
        mp = {k: _rep(v, tp) for k, v in mp.items()}
    return mlp(mp, x, ftp)


def unused_leaves(cfg: ModelConfig):
    """Leaf paths of `init_params` that the loss never reads: a model fed
    frame embeddings (``embeds_in``) with an untied head reads no token
    embedding."""
    return {("embed",)} if cfg.embeds_in and not cfg.tie_embeddings else set()


def _embed(params, cfg, ids, tp=None):
    """The embedding rows of `ids`; with `tp` and the rows split over the
    model ranks, each rank looks up the ids in its block (zeros for the
    others) and the ranks' rows are summed. Under sequence parallelism
    (ids (B, S)) the rank's positions of them: the vocab-parallel sum
    reduce-scattered along the sequence, a whole table read at the
    rank's positions' ids through `_rep`."""
    emb = params["embed"]
    rows = emb.shape[0]
    seq = tp is not None and tp.seq
    if tp is None or rows == cfg.vocab_size:
        return _rep(emb, tp)[tp.positions(ids)] if seq else emb[ids]
    local = ids - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    h = emb[local.clamp(0, rows - 1)]
    h = torch.where(inside[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
    return tp.leave(h)


def _embed_inputs(params, cfg, batch, tp=None):
    if cfg.embeds_in:
        x = batch["embeds"].to(cfg.torch_dtype)
        return tp.positions(x) if tp is not None and tp.seq else x
    return _embed(params, cfg, batch["tokens"], tp)


def _self_attention(ap, x, cfg, use_blocked, tp=None):
    if use_blocked:
        return attn_lib.flash_self_attention(ap, x, cfg, sliding_window=cfg.sliding_window,
                                             tp=tp)
    return attn_lib.full_attention(ap, x, cfg, sliding_window=cfg.sliding_window, tp=tp)


def _gate(gate, dtype):
    """A cross layer's tanh gate, computed in f32 (f64 for an f64 model:
    under sequence parallelism its gradient is summed over the ranks'
    positions, so an f32 one would round each rank's part), in `dtype`."""
    return torch.tanh(gate.to(torch.promote_types(dtype, torch.float32))).to(dtype)


def _apply_block(kind, bp, h, cfg, *, shared, cross_embeds, chunk_fn, use_blocked, tp=None,
                 rows=None):
    """One sub-block; returns the new h (and the aux loss for ``moe``).
    `bp` is the group's sub-block, unused by ``shared``; `tp` the rank's
    place on the model axis, `rows` its place among client ranks that
    split the batch (moe blocks)."""
    if kind == "shared":
        x = rms_norm(h, _rep(shared["norm_attn"], tp), cfg.norm_eps)
        h = h + _self_attention(shared["attn"], x, cfg, use_blocked, tp)
        x = rms_norm(h, _rep(shared["norm_mlp"], tp), cfg.norm_eps)
        return h + _mlp(shared["mlp"], x, cfg, tp)
    x = rms_norm(h, _rep(bp["norm"], tp), cfg.norm_eps)
    if kind == "attn":
        return h + _self_attention(bp["attn"], x, cfg, use_blocked, tp)
    if kind == "mlp":
        return h + _mlp(bp["mlp"], x, cfg, tp)
    if kind == "moe":
        y, aux = moe_block(bp["moe"], x, cfg, tp, rows)
        return h + y, aux
    if kind == "ssm":
        return h + ssm_block(bp["ssm"], x, cfg, chunk_fn=chunk_fn, tp=tp)
    if kind == "cross":
        y = attn_lib.full_attention(bp["attn"], x, cfg, kv_x=cross_embeds, cross=True, tp=tp)
        return h + _gate(_rep(bp["gate"], tp), y.dtype) * y
    raise ValueError(kind)


def apply_model(params, cfg: ModelConfig, batch, *, chunk_fn=None,
                blocked_attn_threshold: int = 8192, return_hidden: bool = False):
    """Full-sequence forward: batch ``{"tokens": (B, S) int}`` (audio:
    ``{"embeds": (B, S, d)}``; vlm also ``"cross_embeds": (B, P, d)``) ->
    (logits (B, S, V), aux 0-d f32: the moe blocks' load-balance losses
    summed over groups, 0 for the other families).

    Self-attention takes the flash path when ``S >= blocked_attn_threshold``
    (not in the ssm family, which has none). `return_hidden` returns the
    final-normed hidden states (B, S, d) in place of the logits, as the
    head takes them (`_head_input`: under tensor parallelism through its
    join).
    `chunk_fn` replaces the SSD intra-chunk step of the ssm blocks
    (default: the kernel; ``kernels.ssd.ref.ssd_chunk_ref`` is the plain
    path).

    Under a `repro_torch.sharding.tp.use` context the logits are the
    rank's block of the vocabulary (see the module docstring); a context
    with sequence parallelism keeps the rank's S / T positions of the
    residual stream between the sub-blocks (the whole of it where the
    model axis does not divide S), each sub-block tallied."""
    pattern, n_groups = block_pattern(cfg)
    asked, rows = tp_lib.current(), tp_lib.current_rows()
    S = (batch["embeds"] if cfg.embeds_in else batch["tokens"]).shape[1]
    tp = None if asked is None else asked.for_seq(S)
    h = _embed_inputs(params, cfg, batch, tp)
    use_blocked = S >= blocked_attn_threshold and cfg.family != "ssm"
    cross_embeds = batch.get("cross_embeds") if cfg.family == "vlm" else None
    if cross_embeds is not None:
        cross_embeds = cross_embeds.to(h.dtype)

    def group_fn(h, gp, shared):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, kind in enumerate(pattern):
            out = _apply_block(kind, gp.get(f"{i}:{kind}"), h, cfg, shared=shared,
                               cross_embeds=cross_embeds, chunk_fn=chunk_fn,
                               use_blocked=use_blocked, tp=tp, rows=rows)
            if kind == "moe":
                h, a = out
                aux = aux + a
            else:
                h = out
            if asked is not None and asked.seq:
                asked.count_seq(tp.seq)
        return h, aux

    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    shared = params.get("shared")
    # a moe group is recomputed whole: an early stop raises inside the
    # forward of the op that packs the group's last saved tensor, there
    # the expert combine's autograd function, whose apply turns it into a
    # SystemError on torch 2.11 (the combine is the group's last product,
    # so little else is recomputed)
    early_stop = cfg.family != "moe"
    for gp in _unbind_groups(params["groups"], n_groups):
        if cfg.remat and torch.is_grad_enabled():
            with set_checkpoint_early_stop(early_stop):
                h, aux = checkpoint(group_fn, h, gp, shared, use_reentrant=False)
        else:
            h, aux = group_fn(h, gp, shared)
        aux_total = aux_total + aux
    x = _head_input(params, cfg, _final_norm(params, cfg, h, tp), tp)
    return (x if return_hidden else x @ _head(params, cfg)), aux_total


def _labels_and_mask(batch):
    """``batch["labels"]`` when given (audio), else next-token labels
    (tokens shifted left, wrapping around); an f32 mask that drops the
    last position either way."""
    if "labels" in batch:
        labels = batch["labels"]
    else:
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask[:, -1] = 0.0
    return labels, mask


def _chunk_nll(h_c, w, l_c, m_c, tp=None):
    """Summed masked NLL of one chunk, in f32 (f64 for an f64 model): its
    (B, C, V) logits live only here (with `tp`, the rank's vocabulary
    block of them)."""
    logits = h_c @ w
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if tp is not None:
        return (token_nll(logits, l_c, tp) * m_c).sum()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_c[..., None].long())[..., 0]
    return ((logz - gold) * m_c).sum()


def lm_loss(params, cfg: ModelConfig, batch, *, chunk_fn=None, vocab_chunk: int = 0,
            blocked_attn_threshold: int = 8192):
    """Next-token cross-entropy (mean over unmasked positions) plus aux.

    ``vocab_chunk=0`` (what the trainer calls) takes the full logits.
    ``vocab_chunk > 0`` never holds them: the hidden states run through
    the head in chunks of `vocab_chunk` positions, each under a
    checkpoint, so the backward recomputes a chunk's logits (logsumexp in
    f32); S must be a multiple of `vocab_chunk`. `chunk_fn` and
    `blocked_attn_threshold` as in `apply_model`. Under a
    `repro_torch.sharding.tp.use` context both forms take the
    vocab-parallel cross-entropy on the rank's block of the logits."""
    labels, mask = _labels_and_mask(batch)
    vtp = _vocab_tp(params, cfg, tp_lib.current())
    if vocab_chunk <= 0:
        logits, aux = apply_model(params, cfg, batch, chunk_fn=chunk_fn,
                                  blocked_attn_threshold=blocked_attn_threshold)
        return cross_entropy(logits, labels, mask, vtp) + aux

    h, aux = apply_model(params, cfg, batch, chunk_fn=chunk_fn,
                         blocked_attn_threshold=blocked_attn_threshold,
                         return_hidden=True)
    w = _head(params, cfg)
    S = h.shape[1]
    C = vocab_chunk
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of vocab_chunk {C}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // C):
        sl = slice(c * C, (c + 1) * C)
        if torch.is_grad_enabled():
            nll = checkpoint(_chunk_nll, h[:, sl], w, labels[:, sl], mask[:, sl], vtp,
                             use_reentrant=False)
        else:
            nll = _chunk_nll(h[:, sl], w, labels[:, sl], mask[:, sl], vtp)
        tot = tot + nll
        cnt = cnt + mask[:, sl].sum()
    return tot / torch.clamp(cnt, min=1.0) + aux


# ---------------------------------------------------------------------------
# Decode (one token, KV/SSM caches)
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: Any  # {"<i>:<kind>": KVCache | SSMState}, leaves (n_groups, B, ...)
    pos: torch.Tensor  # 0-d int32 on the device: the current position


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None, mesh=None, layout=None) -> DecodeState:
    """Zero caches for serving `seq_len` positions: a ring of
    ``sliding_window`` slots when the window is on and shorter than
    `seq_len`, else `seq_len` slots; ``pos`` 0. On a `mesh` with a
    "model" axis, a KV cache holds the kv heads the rank computes
    (`attention.rank_heads`): its block of them where the axis divides
    them (the reference's ``cache_spec``), else the ones its query heads
    read; an `SSMState` holds the rank's ssm heads and the conv channels
    they read (`ssm.rank_ssm_heads`). A `layout`
    (`repro_torch.sharding.tp.CacheLayout`, its mesh the `mesh`) lays
    each KV cache otherwise: the rank's block of the slots where they
    split, every kv head where it says so, the rank's block of head_dim
    where that splits (`repro_torch.launch.steps.cache_layout`)."""
    dev = resolve_device(device)
    if mesh is None and layout is not None:
        mesh = layout.mesh
    t = getattr(mesh, "model_size", 1) if mesh is not None else 1
    pattern, n_groups = block_pattern(cfg)
    n_kv, ssm_heads, ssm_groups = cfg.num_kv_heads, None, None
    every = layout is not None and layout.every_head
    if t > 1 and cfg.num_heads and not every:
        _, _, _, n_kv = attn_lib.rank_heads(
            cfg, mesh.model_rank, t, cfg.num_heads * cfg.resolved_head_dim % t == 0,
            cfg.num_kv_heads % t == 0)
    if t > 1 and "ssm" in pattern:
        _, ssm_heads, _, ssm_groups = rank_ssm_heads(cfg, mesh.model_rank, t)
    dtype = cfg.torch_dtype
    ring = cfg.sliding_window > 0 and seq_len > cfg.sliding_window
    cache_len = cfg.sliding_window if ring else seq_len
    hd = cfg.resolved_head_dim
    if layout is not None:
        cache_len //= layout.slot_block()[1]
        hd //= layout.hd_block()[1]
    caches = {}
    for i, kind in enumerate(pattern):
        if kind in ("attn", "shared"):
            caches[f"{i}:{kind}"] = KVCache.init(
                batch, cache_len, n_kv, hd, dtype, device=dev, lead=(n_groups,))
        elif kind == "ssm":
            caches[f"{i}:{kind}"] = SSMState.init(batch, cfg, dtype, device=dev,
                                                  lead=(n_groups,), heads=ssm_heads,
                                                  groups=ssm_groups)
    return DecodeState(caches=caches, pos=torch.zeros((), dtype=torch.int32, device=dev))


def init_cross_kv(params, cfg: ModelConfig, patch_embeds, mesh=None):
    """The cross-attention K/V of the patch embeddings (B, P, d), stacked
    per group: ``{"k": (n_groups, B, P, Hkv, hd), "v": ...}``; None for a
    model without cross-attention.

    On a `mesh` whose "model" axis is larger than 1, `params` are the
    rank's blocks and the K/V hold the kv heads the rank computes, by the
    rule of `init_decode_state`: its own block where ``wk`` splits at
    whole heads, else the heads its query heads read, sliced from the
    gathered leaf (`attention.rank_kv_weights`). The reference lays the
    cross K/V's head axis over "model" only where it divides and
    replicates all of it otherwise (8 kv heads over 16 ranks: every rank
    holds 8); the port holds the heads a rank reads (1 there)."""
    pattern, n_groups = block_pattern(cfg)
    idx = [i for i, k in enumerate(pattern) if k == "cross"]
    if not idx:
        return None
    (i,) = idx
    tp = tp_lib.context(mesh)
    hd = cfg.resolved_head_dim
    ks, vs = [], []
    with torch.no_grad():
        for gp in _unbind_groups(params["groups"], n_groups):
            wk, wv, hkv = attn_lib.rank_kv_weights(gp[f"{i}:cross"]["attn"], cfg, tp)
            x = patch_embeds.to(wk.dtype)
            ks.append((x @ wk).reshape(*x.shape[:-1], hkv, hd))
            vs.append((x @ wv).reshape(*x.shape[:-1], hkv, hd))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def token_embeds(params, cfg: ModelConfig, tok, mesh=None):
    """(B, 1, d) in ``cfg.dtype``: the embedding rows of tokens `tok` (B,),
    what an ``embeds_in`` model (audio) is fed back at decode. On a `mesh`
    whose "model" axis is larger than 1 the rank holds a block of the
    rows, and the lookup is the vocab-parallel one (`_embed`: each rank
    looks up the ids in its block, the rows summed over the ranks)."""
    return _embed(params, cfg, tok, tp_lib.context(mesh))[:, None, :].to(cfg.torch_dtype)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token_or_embed, state: DecodeState,
                cross_kv=None):
    """One decode step: token (B,) int or embedding (B, 1, d) (an
    ``embeds_in`` model) -> ``(logits (B, V), DecodeState)``.

    Every cache of `state` is updated in place, group by group (the
    returned state holds the same tensors and ``pos + 1``), so pass each
    state once. A model with cross-attention needs `cross_kv`
    (`init_cross_kv`, with the mesh under tensor parallelism). Under a
    `repro_torch.sharding.tp.use` context the logits are the rank's block
    of the vocabulary, and the KV caches lie as its `CacheLayout` says
    (the state from `init_decode_state` with that layout)."""
    pattern, n_groups = block_pattern(cfg)
    tp, rows, layout = tp_lib.current(), tp_lib.current_rows(), tp_lib.current_cache()
    parts = 1 if layout is None else layout.slot_block()[1]
    if "cross" in pattern and cross_kv is None:
        raise ValueError(f"{cfg.name}: a vlm decode needs cross_kv (init_cross_kv)")
    if cfg.embeds_in:
        h = token_or_embed.to(cfg.torch_dtype)
    else:
        h = _embed(params, cfg, token_or_embed, tp)[:, None, :]
    pos = state.pos
    shared = params.get("shared")
    for g, gp in enumerate(_unbind_groups(params["groups"], n_groups)):
        for i, kind in enumerate(pattern):
            name = f"{i}:{kind}"
            if kind in ("attn", "shared"):
                bp = shared if kind == "shared" else gp[name]
                norm = bp["norm_attn"] if kind == "shared" else bp["norm"]
                x = rms_norm(h, norm, cfg.norm_eps)
                cache = state.caches[name]
                view = KVCache(cache.k[g], cache.v[g])
                ring = cfg.sliding_window > 0 and view.k.shape[1] * parts == cfg.sliding_window
                y, _ = attn_lib.decode_attention(bp["attn"], x, view, pos, cfg, ring=ring, tp=tp,
                                                 layout=layout)
                h = h + y
                if kind == "shared":
                    x = rms_norm(h, shared["norm_mlp"], cfg.norm_eps)
                    h = h + mlp(shared["mlp"], x, _ff_tp(shared["mlp"], cfg, tp))
            elif kind == "mlp":
                x = rms_norm(h, gp[name]["norm"], cfg.norm_eps)
                h = h + mlp(gp[name]["mlp"], x, _ff_tp(gp[name]["mlp"], cfg, tp))
            elif kind == "moe":
                x = rms_norm(h, gp[name]["norm"], cfg.norm_eps)
                y, _ = moe_block(gp[name]["moe"], x, cfg, tp, rows)
                h = h + y
            elif kind == "ssm":
                x = rms_norm(h, gp[name]["norm"], cfg.norm_eps)
                st = state.caches[name]
                y, _ = ssm_decode_step(gp[name]["ssm"], x, SSMState(st.conv[g], st.h[g]),
                                       cfg, tp)
                h = h + y
            elif kind == "cross":
                x = rms_norm(h, gp[name]["norm"], cfg.norm_eps)
                y = attn_lib.cross_decode_attention(gp[name]["attn"], x, cross_kv["k"][g],
                                                    cross_kv["v"][g], cfg, tp)
                h = h + _gate(gp[name]["gate"], y.dtype) * y
    logits = _logits(params, cfg, h, tp)[:, 0, :]
    return logits, DecodeState(caches=state.caches, pos=pos + 1)

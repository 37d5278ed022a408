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
device, so they are left out. Decode, the hidden-state output, blocked
attention (S >= 8192) and the chunked-vocab loss (``vocab_chunk > 0``)
come with ROADMAP item 13.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import as_generator
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import cross_entropy, dense_init, init_mlp, mlp, rms_norm
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.ssm import init_ssm, ssm_block


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


def init_params(key, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Single-client parameters: ``{embed (V, d), final_norm (d,),
    groups {"0:attn": ..., "1:mlp": ...} with (n_groups, ...) leaves}``
    plus ``lm_head (d, V)`` when embeddings are untied and ``shared``
    (the hybrid's shared block), in ``cfg.dtype``.

    `key` is an int seed or a `torch.Generator` (see `as_generator`);
    the draws differ from the reference's threefry ones, the layout and
    scales do not."""
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

    per_group = [init_group() for _ in range(n_groups)]
    groups = _stack_groups(per_group)
    params = {
        "embed": dense_init(gen, (cfg.vocab_size, d), d, dtype),
        "groups": groups,
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), d, dtype)
    if cfg.family == "hybrid":
        params["shared"] = {
            "norm_attn": zeros(d),
            "attn": attn_lib.init_attention(gen, cfg),
            "norm_mlp": zeros(d),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype),
        }
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


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def unused_leaves(cfg: ModelConfig):
    """Leaf paths of `init_params` that the loss never reads: a model fed
    frame embeddings (``embeds_in``) with an untied head reads no token
    embedding."""
    return {("embed",)} if cfg.embeds_in and not cfg.tie_embeddings else set()


def _embed_inputs(params, cfg, batch):
    if cfg.embeds_in:
        return batch["embeds"].to(cfg.torch_dtype)
    return params["embed"][batch["tokens"]]


def _apply_block(kind, bp, h, cfg, *, shared, cross_embeds, chunk_fn):
    """One sub-block; returns the new h (and the aux loss for ``moe``).
    `bp` is the group's sub-block, unused by ``shared``."""
    if kind == "shared":
        x = rms_norm(h, shared["norm_attn"], cfg.norm_eps)
        h = h + attn_lib.full_attention(shared["attn"], x, cfg,
                                        sliding_window=cfg.sliding_window)
        x = rms_norm(h, shared["norm_mlp"], cfg.norm_eps)
        return h + mlp(shared["mlp"], x)
    x = rms_norm(h, bp["norm"], cfg.norm_eps)
    if kind == "attn":
        return h + attn_lib.full_attention(bp["attn"], x, cfg,
                                           sliding_window=cfg.sliding_window)
    if kind == "mlp":
        return h + mlp(bp["mlp"], x)
    if kind == "moe":
        y, aux = moe_block(bp["moe"], x, cfg)
        return h + y, aux
    if kind == "ssm":
        return h + ssm_block(bp["ssm"], x, cfg, chunk_fn=chunk_fn)
    if kind == "cross":
        y = attn_lib.full_attention(bp["attn"], x, cfg, kv_x=cross_embeds, cross=True)
        return h + torch.tanh(bp["gate"].to(torch.float32)).to(y.dtype) * y
    raise ValueError(kind)


def apply_model(params, cfg: ModelConfig, batch, *, chunk_fn=None):
    """Full-sequence forward: batch ``{"tokens": (B, S) int}`` (audio:
    ``{"embeds": (B, S, d)}``; vlm also ``"cross_embeds": (B, P, d)``) ->
    (logits (B, S, V), aux 0-d f32: the moe blocks' load-balance losses
    summed over groups, 0 for the other families).

    `chunk_fn` replaces the SSD intra-chunk step of the ssm blocks
    (default: the kernel; ``kernels.ssd.ref.ssd_chunk_ref`` is the plain
    path)."""
    pattern, n_groups = block_pattern(cfg)
    h = _embed_inputs(params, cfg, batch)
    S = h.shape[1]
    if S >= 8192 and cfg.family != "ssm":
        raise NotImplementedError(
            "the reference switches to blocked attention at S >= 8192; "
            "that path is ROADMAP item 13 and not ported yet")
    cross_embeds = batch.get("cross_embeds") if cfg.family == "vlm" else None
    if cross_embeds is not None:
        cross_embeds = cross_embeds.to(h.dtype)

    def group_fn(h, gp, shared):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, kind in enumerate(pattern):
            out = _apply_block(kind, gp.get(f"{i}:{kind}"), h, cfg, shared=shared,
                               cross_embeds=cross_embeds, chunk_fn=chunk_fn)
            if kind == "moe":
                h, a = out
                aux = aux + a
            else:
                h = out
        return h, aux

    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    shared = params.get("shared")
    for gp in _unbind_groups(params["groups"], n_groups):
        if cfg.remat and torch.is_grad_enabled():
            h, aux = checkpoint(group_fn, h, gp, shared, use_reentrant=False)
        else:
            h, aux = group_fn(h, gp, shared)
        aux_total = aux_total + aux
    return _logits(params, cfg, h), aux_total


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


def lm_loss(params, cfg: ModelConfig, batch, *, chunk_fn=None):
    """Next-token cross-entropy (mean over unmasked positions) plus aux,
    from the full logits: the reference's ``vocab_chunk=0``, which is what
    the trainer calls. `chunk_fn` as in `apply_model`."""
    labels, mask = _labels_and_mask(batch)
    logits, aux = apply_model(params, cfg, batch, chunk_fn=chunk_fn)
    return cross_entropy(logits, labels, mask) + aux

"""The unified decoder, dense and ssm families.

Port of `repro.models.model` for the training path of the dense and ssm
families. A model is a repeating *pattern* of sub-blocks over
``n_groups`` (dense: ``['attn', 'mlp'] x L``; ssm: ``['ssm'] x L``). The
parameters keep the reference's **stacked** layout: every leaf of
``params["groups"]`` has a leading group axis (L, ...), under the keys
``"0:attn"`` and ``"1:mlp"`` (dense) or ``"0:ssm"`` (ssm), so the flat
plane of a parameter dict matches the JAX ravel column for column.

The reference's ``lax.scan`` over groups is a loop over ``g`` here, and
its ``jax.checkpoint`` (``cfg.remat``) is
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``. Its
``sharding.axes.constrain`` calls only place activations on a device
mesh and do nothing on one device, so they are left out. The other
families (moe, hybrid, vlm), decode, the hidden-state output and the
chunked-vocab loss (``vocab_chunk > 0``) come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import as_generator
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import cross_entropy, dense_init, init_mlp, mlp, rms_norm
from repro_torch.models.ssm import init_ssm, ssm_block


def block_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int]:
    """(sub-block kinds of one group, number of groups)."""
    if cfg.family in ("dense", "audio"):
        if cfg.embeds_in:
            raise NotImplementedError(
                "frame-embedding inputs (audio) are not ported yet")
        return ("attn", "mlp"), cfg.num_layers
    if cfg.family == "ssm":
        return ("ssm",), cfg.num_layers
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported to repro_torch yet; "
        "only the dense and ssm families are")


def init_params(key, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Single-client parameters: ``{embed (V, d), final_norm (d,),
    groups {"0:attn": ..., "1:mlp": ...} with (L, ...) leaves}`` plus
    ``lm_head (d, V)`` when embeddings are untied, in ``cfg.dtype``.

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
            elif kind == "mlp":
                gp[name] = {"norm": zeros(d),
                            "mlp": init_mlp(gen, d, cfg.d_ff, dtype)}
            elif kind == "ssm":
                gp[name] = {"norm": zeros(d), "ssm": init_ssm(gen, cfg)}
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


def _apply_block(kind, bp, h, cfg, sliding_window, chunk_fn):
    x = rms_norm(h, bp["norm"], cfg.norm_eps)
    if kind == "attn":
        return h + attn_lib.full_attention(bp["attn"], x, cfg,
                                           sliding_window=sliding_window)
    if kind == "mlp":
        return h + mlp(bp["mlp"], x)
    if kind == "ssm":
        return h + ssm_block(bp["ssm"], x, cfg, chunk_fn=chunk_fn)
    raise ValueError(kind)


def apply_model(params, cfg: ModelConfig, batch, *, chunk_fn=None):
    """Full-sequence forward: batch ``{"tokens": (B, S) int}`` ->
    (logits (B, S, V), aux scalar f32); aux is 0 for these families.

    `chunk_fn` replaces the SSD intra-chunk step of the ssm blocks
    (default: the kernel; ``kernels.ssd.ref.ssd_chunk_ref`` is the plain
    path)."""
    pattern, n_groups = block_pattern(cfg)
    h = params["embed"][batch["tokens"]]
    S = h.shape[1]
    if S >= 8192 and cfg.family != "ssm":
        raise NotImplementedError(
            "the reference switches to blocked attention at S >= 8192; "
            "that path is not ported yet")

    def group_fn(h, gp):
        for i, kind in enumerate(pattern):
            h = _apply_block(kind, gp[f"{i}:{kind}"], h, cfg, cfg.sliding_window,
                             chunk_fn)
        return h

    for gp in _unbind_groups(params["groups"], n_groups):
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(group_fn, h, gp, use_reentrant=False)
        else:
            h = group_fn(h, gp)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux


def _labels_and_mask(batch):
    """Next-token labels (tokens shifted left, wrapping around) and an f32
    mask that drops the last position."""
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

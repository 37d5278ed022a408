"""Model registry: one build/apply/loss surface over the unified decoder.

Port of `repro.models.registry`, the same surface for all ten
architectures of `ARCH_IDS`: init, apply, loss and the decode fields
(``init_decode_state``, ``decode_step``, ``init_cross_kv``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig, get_config, get_reduced
from repro_torch.models import model as M


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable  # (key, device=None) -> params
    apply: Callable  # (params, batch) -> (logits, aux)
    loss: Callable  # (params, batch) -> scalar
    init_decode_state: Callable  # (batch, seq_len, device=None) -> DecodeState
    decode_step: Callable  # (params, tok, state, cross_kv=None) -> (logits, state)
    init_cross_kv: Callable  # (params, patch_embeds) -> cross kv or None


def build_model(cfg_or_name) -> Model:
    cfg = cfg_or_name if isinstance(cfg_or_name, ModelConfig) else get_config(cfg_or_name)
    return Model(
        cfg=cfg,
        init=lambda key, device=None: M.init_params(key, cfg, device),
        apply=lambda params, batch, **kw: M.apply_model(params, cfg, batch, **kw),
        loss=lambda params, batch, **kw: M.lm_loss(params, cfg, batch, **kw),
        init_decode_state=lambda batch, seq_len, device=None: M.init_decode_state(
            cfg, batch, seq_len, device),
        decode_step=lambda params, tok, state, cross_kv=None: M.decode_step(
            params, cfg, tok, state, cross_kv),
        init_cross_kv=lambda params, patch_embeds: M.init_cross_kv(params, cfg, patch_embeds),
    )


def build_reduced(name: str) -> Model:
    return build_model(get_reduced(name))

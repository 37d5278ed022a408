"""Model registry: one build/apply/loss surface over the unified decoder.

Port of `repro.models.registry` for training, the same surface for all
ten architectures of `ARCH_IDS`; the decode fields (``init_decode_state``,
``decode_step``, ``init_cross_kv``) come with serving (ROADMAP item 13).
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


def build_model(cfg_or_name) -> Model:
    cfg = cfg_or_name if isinstance(cfg_or_name, ModelConfig) else get_config(cfg_or_name)
    return Model(
        cfg=cfg,
        init=lambda key, device=None: M.init_params(key, cfg, device),
        apply=lambda params, batch: M.apply_model(params, cfg, batch),
        loss=lambda params, batch: M.lm_loss(params, cfg, batch),
    )


def build_reduced(name: str) -> Model:
    return build_model(get_reduced(name))

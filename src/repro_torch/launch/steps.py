"""Step functions of the trainer and the server (port of
`repro.launch.steps`) on one device.

`make_unify_step` is the trainer's periodic unification; `serve_config`,
`make_prefill_step` and `make_serve_step` are serving's: prefill a full
prompt (the flash path at S >= 8192) and decode one token against a
KV/SSM cache, on the unified model (one copy of the parameters). Each
`make_*` function takes ``mesh=None`` only: the reference's mesh steps
and their abstract input specs wait for `torch.distributed`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.flat import tree_leaves
from repro_torch.models import model as M


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(f"the mesh {what} needs torch.distributed, "
                                  "which is not ported yet")


def serve_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Serving variant: at long_500k the attention families (and the
    hybrid's shared attention) get a sliding window of 8192, a ring
    cache; ssm decodes in O(1) as it is."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm", "audio"):
        return cfg.with_(sliding_window=8192)
    if shape.name == "long_500k" and cfg.family == "hybrid":
        return cfg.with_(sliding_window=8192)
    return cfg


def make_unify_step(cfg, mesh=None):
    """Periodic unification: the hub's params broadcast to every client.

    Returns ``unify_step(params, hub) -> params``. It overwrites every
    client's row with the hub's, leaf by leaf and in place (the
    reference returns a new pytree; in place, a full-size model keeps
    one copy of its parameters on the card). `hub` is an int or a
    0-d integer tensor."""
    _no_mesh(mesh, "unification step")

    @torch.no_grad()
    def unify_step(params, hub):
        hub = int(hub)
        for leaf in tree_leaves(params):
            row = leaf[hub].clone()
            leaf.copy_(row.expand_as(leaf))
        return params

    return unify_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """``prefill_step(params, batch) -> logits (B, V)`` at the last
    position: `apply_model` under `serve_config`, without gradients."""
    _no_mesh(mesh, "prefill step")
    scfg = serve_config(cfg, shape)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.apply_model(params, scfg, batch)
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """``serve_step(params, tok, state, cross_kv=None) -> (logits, state)``:
    one `decode_step` under `serve_config` (its caches updated in place)."""
    _no_mesh(mesh, "serve step")
    scfg = serve_config(cfg, shape)

    def serve_step(params, tok, state, cross_kv=None):
        return M.decode_step(params, scfg, tok, state, cross_kv)

    return serve_step

"""Parameter-dict checkpoints: flattened-key .npz, atomic writes, step index.

Port of `repro.checkpoint.ckpt` with the same on-disk layout, so that a
checkpoint written by the JAX trainer restores into the port and back:
``<dir>/step_<k:08d>.npz`` with one array per leaf under its key path
joined by ``/`` (e.g. ``groups/0:attn/attn/wq``), bf16 leaves stored as
their uint16 bit patterns under ``<path>::bf16``. Only nested dicts are
handled (the port's parameter trees are dicts).
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.flat import tree_from_items, tree_items

_SEP = "/"
_BF16 = "::bf16"


def _to_numpy(leaf: torch.Tensor):
    """(key suffix, host array): bf16 as uint16 bits, npz has no bf16."""
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return _BF16, leaf.view(torch.int16).numpy().view(np.uint16)
    return "", leaf.numpy()


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write `tree` (a nested dict of tensors) as ``step_<step>.npz``,
    atomically (a temporary file renamed into place). Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {}
    for path, leaf in tree_items(tree):
        suffix, arr = _to_numpy(leaf)
        flat[_SEP.join(path) + suffix] = arr
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest k with a ``step_<k>.npz`` in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)\.npz$", f)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of `tree_like`: a new dict whose leaves
    have the template leaves' shapes, dtypes and devices (latest step by
    default)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        def lookup(key):
            if key in data:
                return torch.from_numpy(np.array(data[key]))
            if key + _BF16 in data:
                bits = np.array(data[key + _BF16]).view(np.int16)
                return torch.from_numpy(bits).view(torch.bfloat16)
            raise KeyError(f"checkpoint missing leaf {key}")

        items = []
        for p, leaf in tree_items(tree_like):
            key = _SEP.join(p)
            arr = lookup(key)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key} has shape "
                                 f"{tuple(arr.shape)}, expected {tuple(leaf.shape)}")
            items.append((p, arr.to(device=leaf.device, dtype=leaf.dtype)))
    return tree_from_items(items)

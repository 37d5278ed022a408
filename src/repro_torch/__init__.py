"""`repro_torch` — the PyTorch/CUDA port of `repro`, for one NVIDIA H100.

Module for module it mirrors the JAX package (`repro.core.flat` ->
`repro_torch.core.flat`, ...), written in PyTorch idiom: plain functions
on tensors with an explicit device, a `torch.Generator` per run for the
random draws, client-stacked parameter dicts ``{name: (N, ...)}``,
``jax.vmap`` written out as a batch dimension and ``lax.scan`` as a
Python loop. It imports neither ``jax`` nor ``repro``.

Device policy: the entry points (`simulate`, `init_state`, the data and
task builders) take ``device=None``, which means ``"cuda"``. Without a
card they raise unless the caller asked for ``"cpu"`` explicitly; they
never carry on on the CPU by themselves.

Precision policy: importing the package switches TF32 off for both
cuBLAS matmuls and cuDNN convolutions, so every f32 product runs in full
f32 on the card, as the JAX reference does on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The device entry points run on when the caller names none: CUDA.

    Raises when there is no card, so that nothing falls back to the CPU
    silently; pass ``device="cpu"`` to run on the CPU on purpose."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> `default_device()`; anything else as given."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def as_generator(key: Union[int, torch.Generator, None],
                 device: DeviceLike = None) -> torch.Generator:
    """The port's spelling of a PRNG key: an int seed or a Generator.

    A `torch.Generator` is used as it is (its device is the run's
    device); an int seeds a new generator on `resolve_device(device)`.
    """
    if isinstance(key, torch.Generator):
        if device is not None and torch.device(device).type != key.device.type:
            raise ValueError(f"generator on {key.device}, device={device}")
        return key
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(0 if key is None else int(key))
    return gen


__all__ = ["as_generator", "default_device", "resolve_device"]

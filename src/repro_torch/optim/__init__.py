"""Local optimizers and lr schedules (port of `repro.optim`)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    constant_schedule,
    cosine_schedule,
    momentum,
    sgd,
    warmup_cosine,
)

__all__ = [
    "Optimizer",
    "adamw",
    "apply_updates",
    "constant_schedule",
    "cosine_schedule",
    "momentum",
    "sgd",
    "warmup_cosine",
]

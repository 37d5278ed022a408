"""Models: layer primitives, attention, the unified decoder, registry."""
from repro_torch.models.registry import build_model

__all__ = ["build_model"]

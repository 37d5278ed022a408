"""Synthetic federated data and the paper-scale MLP."""
from repro_torch.data.synthetic import (
    classification_task,
    dirichlet_partition,
    federated_classification,
    lm_token_batches,
    make_mlp,
)

__all__ = [
    "classification_task",
    "dirichlet_partition",
    "federated_classification",
    "lm_token_batches",
    "make_mlp",
]

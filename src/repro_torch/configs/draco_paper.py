"""Paper-faithful experiment configs (Section 5 of DRACO).

Port of `repro.configs.draco_paper` (a copy: the port imports nothing of
the JAX package). The paper trains a small CNN: 596,776 bytes (0.57 MB,
~149k fp32 params) on EMNIST (47 classes) and 51,640 bytes (~12.9k
params) on Poker hand (10 classes). Both packages reproduce them with
same-parameter-scale MLPs on synthetic class-conditional data of matched
dimensionality (the datasets are offline).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class PaperTaskConfig:
    name: str
    input_dim: int
    num_classes: int
    hidden: tuple
    # DRACO simulation defaults (Section 5)
    num_clients: int = 25
    batch_size: int = 64
    local_batches: int = 1  # B
    samples_per_client: int = 1000
    lambda_grad: float = 0.1  # Assumption 1 rate
    lr: float = 0.05
    message_bytes: int = 0


# EMNIST-like: 28x28 inputs, 47 classes, cycle topology in the paper.
EMNIST = PaperTaskConfig(
    name="emnist",
    input_dim=784,
    num_classes=47,
    hidden=(160, 100),
    message_bytes=596_776,
)

# Poker-hand-like: 10 categorical features, 10 classes, complete topology.
POKER = PaperTaskConfig(
    name="poker",
    input_dim=10,
    num_classes=10,
    hidden=(64, 64),
    message_bytes=51_640,
)

TASKS = {"emnist": EMNIST, "poker": POKER}

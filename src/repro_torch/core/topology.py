"""Gossip graph topologies and row-stochastic weight matrices.

Port of `repro.core.topology`. The paper (Sec. 2.2) normalizes
transmission weights across *receivers*: ``sum_{j != i} q^{ij} = 1`` for
every sender i, so Q is **row**-stochastic with zero diagonal and may be
directed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def adjacency(topology: str, n: int, seed: Optional[int] = None,
              p: float = 0.3, directed: bool = False, *,
              device=None) -> torch.Tensor:
    """Boolean (n, n) adjacency, zero diagonal, built on the host.

    ``erdos`` takes a numpy seed (the reference derives its seed from a
    JAX key; pass that integer here to get the same graph).
    """
    if topology == "cycle":
        a = np.zeros((n, n), bool)
        for i in range(n):
            a[i, (i + 1) % n] = True
            if not directed:
                a[i, (i - 1) % n] = True
    elif topology == "ring2d":
        side = int(round(np.sqrt(n)))
        if side * side != n:
            raise ValueError(f"ring2d needs square n, got {n}")
        a = np.zeros((n, n), bool)
        for i in range(n):
            r, c = divmod(i, side)
            for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                a[i, ((r + dr) % side) * side + (c + dc) % side] = True
    elif topology == "complete":
        a = ~np.eye(n, dtype=bool)
    elif topology == "star":
        a = np.zeros((n, n), bool)
        a[0, 1:] = True
        a[1:, 0] = True
    elif topology == "erdos":
        if seed is None:
            raise ValueError("erdos topology needs a seed")
        rng = np.random.default_rng(int(seed))
        a = rng.random((n, n)) < p
        np.fill_diagonal(a, False)
        if not directed:
            a = a | a.T
        # directed Hamiltonian overlay -> strongly connected; mirrored
        # for undirected graphs so the adjacency stays symmetric
        for i in range(n):
            a[i, (i + 1) % n] = True
            if not directed:
                a[(i + 1) % n, i] = True
    else:
        raise ValueError(topology)
    np.fill_diagonal(a, False)
    return torch.as_tensor(a, device=device)


def row_stochastic(adj: torch.Tensor, weights=None) -> torch.Tensor:
    """Row-stochastic Q (N, N) from adjacency (uniform over out-neighbours)."""
    a = adj.to(torch.float32)
    if weights is not None:
        a = a * weights
    deg = a.sum(dim=1, keepdim=True)
    return torch.where(deg > 0, a / torch.clamp(deg, min=1e-9), 0.0)


def metropolis(adj: torch.Tensor) -> torch.Tensor:
    """Symmetric doubly stochastic Metropolis-Hastings weights (N, N) f32
    of the undirected graph ``adj | adj.T``, on `adj`'s device: ``1 / (1 +
    max(deg_i, deg_j))`` on each edge and the rest of each row on the
    diagonal (the sync-symm and async-symm baselines).

    Each row's off-diagonal mass is summed column by column, in order,
    as XLA's CPU row reduction adds up to 32 terms, so the diagonal is
    the reference's to the bit there (and wherever a row has two
    nonzero terms, as on the cycle); above 32 XLA changes its order."""
    a = adj | adj.T
    deg = a.sum(dim=1)
    w = torch.where(a, 1.0 / (1.0 + torch.maximum(deg[:, None], deg[None, :]).to(torch.float32)),
                    0.0)
    total = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
    for j in range(w.shape[1]):
        total = total + w[:, j]
    return w + torch.diag(1.0 - total)


def is_row_stochastic(q: torch.Tensor, atol: float = 1e-5) -> bool:
    """Non-negative Q (N, N), zero diagonal, every nonzero row summing to
    1 within `atol` (host check: validation and tests, not the loop)."""
    rows = q.sum(dim=1)
    ok_rows = torch.abs(torch.where(rows > atol, rows, 1.0) - 1.0) < atol
    return bool((q >= -atol).all() & ok_rows.all() & (torch.diagonal(q) < atol).all())

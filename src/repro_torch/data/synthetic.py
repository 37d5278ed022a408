"""Synthetic federated classification data and the paper-scale MLP.

Port of `repro.data.synthetic`: class-conditional Gaussian mixtures with
matched dimensionality and class counts, Dirichlet non-iid client
partitions, uniform synthetic token streams for the language task, and
the 2-hidden-layer relu MLP that stands in for the paper's 0.57 MB CNN.
Every draw comes from one `torch.Generator` (the
``key`` argument: an int seed or a generator) on the run's device, so
the data is made in bulk on the card.
"""
from __future__ import annotations

import torch

from repro_torch import as_generator
from repro_torch.models.layers import dense_init, token_nll


def classification_task(key, n_samples: int, input_dim: int, num_classes: int,
                        noise: float = 0.6, anchors=None, *, device=None):
    """Gaussian mixture: one anchor per class + noise. Returns (x, y, anchors)."""
    g = as_generator(key, device)
    dev = g.device
    if anchors is None:
        anchors = torch.randn((num_classes, input_dim), generator=g, device=dev)
    y = torch.randint(0, num_classes, (n_samples,), generator=g, device=dev)
    x = anchors[y] + noise * torch.randn((n_samples, input_dim), generator=g,
                                         device=dev)
    return x, y, anchors


def dirichlet_partition(key, y, num_clients: int, num_classes: int,
                        alpha: float = 0.5, per_client: int = 1000, *,
                        device=None):
    """Non-iid split: per-client class distribution ~ Dirichlet(alpha).

    Returns (num_clients, per_client) int64 indices into the dataset,
    sampled with replacement with each sample weighted by its client's
    probability of its class (the reference's categorical over
    ``log props[:, y]``)."""
    g = as_generator(key, device)
    conc = torch.full((num_clients, num_classes), float(alpha),
                      device=g.device)
    props = torch._sample_dirichlet(conc, generator=g)  # (N, classes)
    weights = torch.clamp(props, min=1e-9)[:, y]  # (N, n_samples)
    return torch.multinomial(weights, per_client, replacement=True, generator=g)


def federated_classification(key, num_clients: int, input_dim: int,
                             num_classes: int, per_client: int = 1000,
                             alpha: float = 0.5, test_size: int = 2000,
                             noise: float = 0.6, *, device=None):
    """Per-client train shards + a common test set:
    ``((xs (N, per_client, dim) f32, ys (N, per_client) int64),
    (test_x, test_y))``."""
    g = as_generator(key, device)
    pool_x, pool_y, anchors = classification_task(g, 20_000, input_dim,
                                                  num_classes, noise)
    idx = dirichlet_partition(g, pool_y, num_clients, num_classes, alpha,
                              per_client)
    xs, ys = pool_x[idx], pool_y[idx]
    test_x, test_y, _ = classification_task(g, test_size, input_dim,
                                            num_classes, noise, anchors=anchors)
    return (xs, ys), (test_x, test_y)


def lm_token_batches(key, num_clients: int, per_client: int, seq_len: int,
                     vocab: int, *, device=None) -> torch.Tensor:
    """Uniform synthetic token shards (num_clients, per_client, seq_len)
    int64, drawn on the generator's device."""
    g = as_generator(key, device)
    return torch.randint(0, vocab, (num_clients, per_client, seq_len),
                         generator=g, device=g.device)


def make_mlp(key, input_dim: int, hidden: tuple, num_classes: int, *,
             device=None):
    """Relu MLP ``input_dim -> hidden... -> num_classes``.

    Returns ``(params, apply, loss, accuracy)``; ``params`` is a dict
    ``{w0, b0, w1, b1, ...}`` and the functions are `mlp_fns`'.
    """
    g = as_generator(key, device)
    dims = (input_dim,) + tuple(hidden) + (num_classes,)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = dense_init(g, (a, b), a)
        params[f"b{i}"] = torch.zeros((b,), device=g.device)
    return (params,) + mlp_fns(len(dims) - 1)


def mlp_fns(n_layers: int):
    """``(apply, loss, accuracy)`` of an ``n_layers`` relu MLP.

    They take one client's params or client-stacked params ``(N, ...)``.
    With stacked params, ``x`` is ``(N, B, dim)`` per-client batches or a
    shared ``(T, dim)`` eval set, and `loss` / `accuracy` return the
    ``(N,)`` per-client means (the port's spelling of ``jax.vmap`` over
    clients).
    """

    def apply(p, x):
        h = x
        for i in range(n_layers):
            h = torch.matmul(h, p[f"w{i}"]) + p[f"b{i}"].unsqueeze(-2)
            if i < n_layers - 1:
                h = torch.relu(h)
        return h

    def loss(p, x, y):
        return token_nll(apply(p, x), y).mean(dim=-1)

    def accuracy(p, x, y):
        return (apply(p, x).argmax(dim=-1) == y).to(torch.float32).mean(dim=-1)

    return apply, loss, accuracy

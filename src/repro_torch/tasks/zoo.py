"""The built-in task zoo (port of `repro.tasks.zoo`).

  - ``linear-softmax``: a single dense softmax layer on the Gaussian
    mixture classification data (the default workload);
  - ``mlp``: the paper-style relu MLP on the same data;
  - ``small-cnn``: two 3x3 conv blocks (relu, 2x2 mean pool) and a dense
    head over the mixture reshaped as single-channel images;
  - ``tiny-lm``: a one-block pre-norm transformer decoder (RoPE
    attention, SwiGLU MLP from `repro_torch.models.layers`) on synthetic
    token streams; its metric is perplexity.

Every builder returns plain SGD with a constant schedule unless asked
for another optimizer (``get_task("mlp", optimizer="adamw")`` equals
``get_task("mlp").with_optimizer("adamw")``).

All losses and metrics are batched over clients: params carry a leading
``(N,)`` axis, batches are ``(N, B, ...)`` (or one shared ``(T, ...)``
eval set), and they return the ``(N,)`` per-client values. `grad_cost`
is ``6 * n_params`` MFLOPs per local gradient event per sample (fwd +
~2x bwd, 2 FLOPs per MAC), times ``seq_len`` for the LM and counted over
the spatial positions for the CNN, as in the reference.
"""
from __future__ import annotations

import math
from functools import lru_cache, partial

import torch
import torch.nn.functional as F

from repro_torch import as_generator
from repro_torch.core.flat import tree_leaves
from repro_torch.data.synthetic import (
    federated_classification,
    lm_token_batches,
    make_mlp,
    mlp_fns,
)
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    init_mlp,
    mlp,
    rms_norm,
    token_nll,
)
from repro_torch.tasks.base import Task, register_task


def _param_count(init_params) -> int:
    """Parameters of one client, from an init on the CPU."""
    return sum(leaf.numel() for leaf in
               tree_leaves(init_params(torch.Generator().manual_seed(0))))


def _mflops_per_grad(n_params: int, tokens: int = 1) -> float:
    return 6.0 * n_params * tokens / 1e6


def _nll(logits, y):
    """Per-position NLL; labels of a shared eval set broadcast over clients."""
    return token_nll(logits, y.expand(logits.shape[:-1]))


def _opt_variant(base: Task, optimizer, schedule, opt_kwargs,
                 schedule_kwargs) -> Task:
    """Optimizer variant of a cached base workload: every spelling of one
    workload shares one base task, so the variants compare equal."""
    return base.with_optimizer(optimizer, schedule=schedule,
                               schedule_kwargs=schedule_kwargs,
                               **(opt_kwargs or {}))


# --- classification family (Gaussian mixture, Dirichlet non-iid shards) -----

def _classification_data(key, num_clients, *, input_dim, num_classes,
                         per_client, alpha, noise, test_size, device=None):
    return federated_classification(
        key, num_clients, input_dim=input_dim, num_classes=num_classes,
        per_client=per_client, alpha=alpha, test_size=test_size, noise=noise,
        device=device)


def _mlp_init(key, *, input_dim, hidden, num_classes, device=None):
    return make_mlp(key, input_dim, hidden, num_classes, device=device)[0]


@lru_cache(maxsize=None)
def _mlp_base(name, hidden, input_dim, num_classes, per_client, alpha,
              noise) -> Task:
    dims = (input_dim,) + tuple(hidden) + (num_classes,)
    _, loss, acc = mlp_fns(len(dims) - 1)
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return Task(
        name=name,
        init_params=partial(_mlp_init, input_dim=input_dim, hidden=hidden,
                            num_classes=num_classes),
        loss_fn=loss, eval_fn=acc,
        make_data=partial(_classification_data, input_dim=input_dim,
                          num_classes=num_classes, per_client=per_client,
                          alpha=alpha, noise=noise, test_size=2000),
        metric_name="accuracy",
        grad_cost=_mflops_per_grad(n_params),
    )


@register_task("linear-softmax")
def build_linear_softmax(input_dim: int = 16, num_classes: int = 5,
                         per_client: int = 256, alpha: float = 0.5,
                         noise: float = 0.6, optimizer: str = "sgd",
                         schedule: str = "constant", opt_kwargs=None,
                         schedule_kwargs=None) -> Task:
    """Single dense layer + softmax CE (the reference's default task)."""
    base = _mlp_base("linear-softmax", (), input_dim, num_classes,
                     per_client, alpha, noise)
    return _opt_variant(base, optimizer, schedule, opt_kwargs, schedule_kwargs)


@register_task("mlp")
def build_mlp(input_dim: int = 16, num_classes: int = 5,
              hidden: tuple = (32, 32), per_client: int = 256,
              alpha: float = 0.5, noise: float = 0.6,
              optimizer: str = "sgd", schedule: str = "constant",
              opt_kwargs=None, schedule_kwargs=None) -> Task:
    """Paper-style relu MLP (fig3's EMNIST/Poker stand-in family)."""
    base = _mlp_base("mlp", tuple(hidden), input_dim, num_classes,
                     per_client, alpha, noise)
    return _opt_variant(base, optimizer, schedule, opt_kwargs, schedule_kwargs)


# --- small-cnn: 2 conv blocks + dense head over mixture "images" -------------

def _cnn_init(key, *, side, channels, num_classes, device=None):
    """HWIO conv weights, as the reference lays them out."""
    g = as_generator(key, device)
    c1, c2 = channels
    feat = (side // 4) * (side // 4) * c2
    conv1 = dense_init(g, (3, 3, 1, c1), 9)
    conv2 = dense_init(g, (3, 3, c1, c2), 9 * c1)
    w_head = dense_init(g, (feat, num_classes), feat)
    zeros = partial(torch.zeros, dtype=torch.float32, device=g.device)
    return {"conv1": conv1, "b1": zeros((c1,)), "conv2": conv2, "b2": zeros((c2,)),
            "w_head": w_head, "b_head": zeros((num_classes,))}


def _conv_block(h, w, b):
    """One client-batched SAME 3x3 conv + bias, relu, 2x2 mean pool.

    `h` (N, B, H, W, Cin), `w` (N, 3, 3, Cin, Cout) HWIO, `b` (N, Cout):
    one grouped convolution (groups = N) over the clients' channels."""
    n, bsz, hh, ww, cin = h.shape
    cout = w.shape[-1]
    x = h.permute(1, 0, 4, 2, 3).reshape(bsz, n * cin, hh, ww)
    k = w.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, 3, 3)
    y = F.conv2d(x, k, padding=1, groups=n).reshape(bsz, n, cout, hh, ww)
    y = torch.relu(y.permute(1, 0, 3, 4, 2) + b[:, None, None, None, :])
    return y.reshape(n, bsz, hh // 2, 2, ww // 2, 2, cout).mean(dim=(3, 5))


def _cnn_apply(p, x, *, side):
    """x (N, B, side*side) or a shared (T, side*side) -> logits (N, B, C)."""
    n = p["conv1"].shape[0]
    if x.dim() == 2:
        x = x.expand((n,) + tuple(x.shape))
    h = x.reshape(n, x.shape[1], side, side, 1)
    h = _conv_block(h, p["conv1"], p["b1"])
    h = _conv_block(h, p["conv2"], p["b2"])
    return torch.matmul(h.reshape(n, h.shape[1], -1), p["w_head"]) + p["b_head"][:, None, :]


@lru_cache(maxsize=None)
def _cnn_base(side, num_classes, channels, per_client, alpha, noise) -> Task:
    apply = partial(_cnn_apply, side=side)

    def loss(params, x, y):
        return _nll(apply(params, x), y).mean(dim=-1)

    def accuracy(params, x, y):
        return (apply(params, x).argmax(dim=-1) == y).to(torch.float32).mean(dim=-1)

    return Task(
        name="small-cnn",
        init_params=partial(_cnn_init, side=side, channels=channels,
                            num_classes=num_classes),
        loss_fn=loss, eval_fn=accuracy,
        make_data=partial(_classification_data, input_dim=side * side,
                          num_classes=num_classes, per_client=per_client,
                          alpha=alpha, noise=noise, test_size=1000),
        metric_name="accuracy",
        # conv FLOPs dominate the tiny head: counted over the positions
        grad_cost=_mflops_per_grad(
            9 * 1 * channels[0] * side * side
            + 9 * channels[0] * channels[1] * (side // 2) * (side // 2)
            + (side // 4) * (side // 4) * channels[1] * num_classes),
    )


@register_task("small-cnn")
def build_small_cnn(side: int = 8, num_classes: int = 5,
                    channels: tuple = (8, 16), per_client: int = 256,
                    alpha: float = 0.5, noise: float = 0.6,
                    optimizer: str = "sgd", schedule: str = "constant",
                    opt_kwargs=None, schedule_kwargs=None) -> Task:
    """2-conv + pooled head over `side x side` single-channel mixture
    images (flat ``(B, side*side)`` inputs, reshaped inside apply)."""
    if side % 4 != 0:
        raise ValueError(f"side must be divisible by 4 (two 2x2 pools), got {side}")
    base = _cnn_base(side, num_classes, tuple(channels), per_client, alpha, noise)
    return _opt_variant(base, optimizer, schedule, opt_kwargs, schedule_kwargs)


# --- tiny-lm: one-block pre-norm transformer decoder on synthetic tokens -----

def _lm_init(key, *, vocab, d_model, num_heads, d_ff, device=None):
    g = as_generator(key, device)
    hd = d_model // num_heads
    zeros = partial(torch.zeros, dtype=torch.float32, device=g.device)
    emb = dense_init(g, (vocab, d_model), d_model)
    attn = {"wq": dense_init(g, (d_model, num_heads * hd), d_model),
            "wk": dense_init(g, (d_model, num_heads * hd), d_model),
            "wv": dense_init(g, (d_model, num_heads * hd), d_model),
            "wo": dense_init(g, (num_heads * hd, d_model), num_heads * hd)}
    return {"emb": emb, "ln1": zeros((d_model,)), "attn": attn,
            "ln2": zeros((d_model,)),
            "mlp": init_mlp(g, d_model, d_ff, torch.float32),
            "lnf": zeros((d_model,)),
            "head": dense_init(g, (d_model, vocab), d_model)}


def _lm_apply(p, toks, *, num_heads, rope_theta=10_000.0, eps=1e-5):
    """toks (N, B, S) int, or a shared (B, S) -> logits (N, B, S, V);
    causal RoPE attention."""
    n, d = p["emb"].shape[0], p["emb"].shape[2]
    if toks.dim() == 2:
        toks = toks.expand((n,) + tuple(toks.shape))
    b, s = toks.shape[1], toks.shape[2]
    hd = d // num_heads

    def gain(w):  # (N, d) -> broadcast over (N, B, S, d)
        return w[:, None, None, :]

    def proj(x, w):  # (N, B, S, a) @ (N, a, c)
        return torch.matmul(x, w[:, None])

    # each client's rows of its own table (a gather; its gradient a scatter-add)
    h = torch.gather(p["emb"], 1, toks.reshape(n, b * s, 1).expand(n, b * s, d))
    h = h.reshape(n, b, s, d)
    pos = torch.arange(s, device=toks.device)
    a = rms_norm(h, gain(p["ln1"]), eps)
    att = p["attn"]
    q = apply_rope(proj(a, att["wq"]).reshape(n, b, s, num_heads, hd), pos, rope_theta)
    k = apply_rope(proj(a, att["wk"]).reshape(n, b, s, num_heads, hd), pos, rope_theta)
    v = proj(a, att["wv"]).reshape(n, b, s, num_heads, hd)
    scores = torch.einsum("nbqhd,nbkhd->nbhqk", q, k) / math.sqrt(hd)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=toks.device))
    scores = torch.where(causal, scores, -1e30)
    out = torch.einsum("nbhqk,nbkhd->nbqhd", torch.softmax(scores, dim=-1), v)
    h = h + proj(out.reshape(n, b, s, d), att["wo"])
    ff = {k: w[:, None] for k, w in p["mlp"].items()}
    h = h + mlp(ff, rms_norm(h, gain(p["ln2"]), eps))
    return proj(rms_norm(h, gain(p["lnf"]), eps), p["head"])


def _lm_data(key, num_clients, *, per_client, seq_len, vocab, eval_size, device=None):
    g = as_generator(key, device)
    toks = lm_token_batches(g, num_clients, per_client, seq_len + 1, vocab)
    ev = lm_token_batches(g, 1, eval_size, seq_len + 1, vocab)[0]
    return (toks[..., :-1], toks[..., 1:]), (ev[:, :-1], ev[:, 1:])


@lru_cache(maxsize=None)
def _lm_base(vocab, d_model, num_heads, d_ff, seq_len, per_client, eval_size) -> Task:
    init = partial(_lm_init, vocab=vocab, d_model=d_model, num_heads=num_heads,
                   d_ff=d_ff)
    apply = partial(_lm_apply, num_heads=num_heads)

    def loss(params, x, y):
        return _nll(apply(params, x), y).mean(dim=(-2, -1))

    def perplexity(params, ex, ey):
        return torch.exp(torch.clamp(loss(params, ex, ey), max=20.0))

    return Task(
        name="tiny-lm", init_params=init, loss_fn=loss, eval_fn=perplexity,
        make_data=partial(_lm_data, per_client=per_client, seq_len=seq_len,
                          vocab=vocab, eval_size=eval_size),
        metric_name="perplexity",
        grad_cost=_mflops_per_grad(_param_count(init), tokens=seq_len),
    )


@register_task("tiny-lm")
def build_tiny_lm(vocab: int = 64, d_model: int = 32, num_heads: int = 2,
                  d_ff: int = 64, seq_len: int = 16, per_client: int = 128,
                  eval_size: int = 64, optimizer: str = "sgd",
                  schedule: str = "constant", opt_kwargs=None,
                  schedule_kwargs=None) -> Task:
    """One-block pre-norm decoder on the synthetic token streams; metric
    per-client perplexity on a held-out stream (lower is better)."""
    if d_model % num_heads != 0:
        raise ValueError(f"d_model={d_model} not divisible by num_heads={num_heads}")
    base = _lm_base(vocab, d_model, num_heads, d_ff, seq_len, per_client, eval_size)
    return _opt_variant(base, optimizer, schedule, opt_kwargs, schedule_kwargs)

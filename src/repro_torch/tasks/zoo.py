"""Built-in tasks of this slice: ``linear-softmax`` and ``mlp``.

Port of the classification family of `repro.tasks.zoo`, with plain SGD
and a constant schedule. ``small-cnn``, ``tiny-lm`` and the other
optimizers wait for ROADMAP.md queue 1 item 8; asking for them raises.

`grad_cost` is ``6 * n_params`` MFLOPs per local gradient event (fwd +
~2x bwd, 2 FLOPs per MAC), as in the reference.
"""
from __future__ import annotations

from functools import lru_cache, partial

from repro_torch.data.synthetic import federated_classification, make_mlp, mlp_fns
from repro_torch.tasks.base import OPTIMIZER_ROADMAP, Task, register_task


def _mflops_per_grad(n_params: int) -> float:
    return 6.0 * n_params / 1e6


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


def _sgd_only(optimizer, schedule, opt_kwargs, schedule_kwargs):
    if (optimizer != "sgd" or schedule != "constant" or opt_kwargs
            or schedule_kwargs):
        raise NotImplementedError(
            f"optimizer {optimizer}/{schedule} is not ported; see "
            f"{OPTIMIZER_ROADMAP}")


@register_task("linear-softmax")
def build_linear_softmax(input_dim: int = 16, num_classes: int = 5,
                         per_client: int = 256, alpha: float = 0.5,
                         noise: float = 0.6, optimizer: str = "sgd",
                         schedule: str = "constant", opt_kwargs=None,
                         schedule_kwargs=None) -> Task:
    """Single dense layer + softmax CE (the reference's default task)."""
    _sgd_only(optimizer, schedule, opt_kwargs, schedule_kwargs)
    return _mlp_base("linear-softmax", (), input_dim, num_classes,
                     per_client, alpha, noise)


@register_task("mlp")
def build_mlp(input_dim: int = 16, num_classes: int = 5,
              hidden: tuple = (32, 32), per_client: int = 256,
              alpha: float = 0.5, noise: float = 0.6,
              optimizer: str = "sgd", schedule: str = "constant",
              opt_kwargs=None, schedule_kwargs=None) -> Task:
    """Paper-style relu MLP (fig3's EMNIST/Poker stand-in family)."""
    _sgd_only(optimizer, schedule, opt_kwargs, schedule_kwargs)
    return _mlp_base("mlp", tuple(hidden), input_dim, num_classes,
                     per_client, alpha, noise)

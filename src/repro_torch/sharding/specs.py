"""PartitionSpec rules for parameter dicts (port of `repro.sharding.specs`).

``param_spec(path, shape, mesh, prefix)`` maps a parameter's key path and
shape to a `PartitionSpec`. The core rule set is tensor parallelism over
"model":

  - projections *into* the sharded dim (wq/wk/wv/w_gate/w_up, ssm
    in_proj): last dim on "model"
  - projections *out of* the sharded dim (wo/w_down/ssm out_proj):
    first core dim on "model"
  - expert-stacked weights: expert axis on "model"
  - embeddings: vocab on "model"; norms, biases and scalars replicated

Axes whose dim is not divisible by the mesh axis's size fall back to
replicated. Leading stack axes (the client axis, the layer-group axis)
are covered by ``prefix`` (padded with None up to the leaf's rank).

These are pure functions of a leaf's path and shape. The port lays the
client axes and "model" over ranks (`repro_torch.launch.mesh`): each
rank holds the block of every leaf that its spec gives it
(`repro_torch.sharding.tp.shard`), and the model code computes on those
blocks (`repro_torch.sharding.tp`).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core import flat as flat_lib


class PartitionSpec(tuple):
    """One entry per array dim: None (replicated), a mesh axis name, or a
    tuple of names (the product of those axes). A tuple, so two specs
    compare as tuples."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# (name fragment, core spec aligned to the LAST len(spec) dims)
_RULES: Tuple[Tuple[str, tuple], ...] = (
    ("embed", ("model", None)),
    ("lm_head", (None, "model")),
    ("wq", (None, "model")),
    ("wk", (None, "model")),
    ("wv", (None, "model")),
    ("wo", ("model", None)),
    ("w_gate", (None, "model")),
    ("w_up", (None, "model")),
    ("w_down", ("model", None)),
    # MoE: stacked (E, d, f)/(E, f, d) -> shard expert axis.
    ("experts_gate", ("model", None, None)),
    ("experts_up", ("model", None, None)),
    ("experts_down", ("model", None, None)),
    ("router", (None, None)),
    # SSD / Mamba2
    ("in_proj", (None, "model")),
    ("out_proj", ("model", None)),
    ("conv_w", ("model", None)),
    ("conv_b", ("model",)),
    ("a_log", ("model",)),
    ("ssm_d", ("model",)),
    ("dt_bias", ("model",)),
    ("gnorm", ("model",)),
)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def filter_divisible(spec, shape, mesh) -> PartitionSpec:
    """Replace spec entries whose mesh-axis size doesn't divide the dim."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is not None and dim % _axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return P(*out)


def param_spec(path, shape, mesh=None, prefix: tuple = ()) -> PartitionSpec:
    """Spec for one param leaf; `path` a key tuple or a ``/``-joined
    string, `prefix` covers leading stack axes."""
    name = path if isinstance(path, str) else _path_str(path)
    ndim = len(shape)
    core = ()  # replicated (norm scales, biases, scalars)
    for frag, spec in _RULES:
        if frag in name:
            core = spec
            break
    n_pad = ndim - len(prefix) - len(core)
    if n_pad < 0:  # leaf rank smaller than rule: replicate the tail
        spec = P(*prefix, *([None] * max(ndim - len(prefix), 0)))
    else:
        spec = P(*prefix, *([None] * n_pad), *core)
    if mesh is not None:
        spec = filter_divisible(spec, shape, mesh)
    return spec


def tree_param_specs(params, prefix: tuple = (), mesh=None):
    """`PartitionSpec` dict matching `params` (the same nested keys);
    leaves need only a ``shape`` (meta tensors do)."""
    return flat_lib.tree_from_items(
        (path, param_spec(path, tuple(leaf.shape), mesh, prefix))
        for path, leaf in flat_lib.tree_items(params))

"""Flat parameter plane: the per-client parameter dict as one buffer.

Port of `repro.core.flat`. Every protocol quantity with a leading
client axis (pending updates, in-flight payloads, consensus residuals)
lives on one contiguous ``(N, Dflat)`` matrix, so mixing, the
delay-bucketed drain, consensus and unification are single ops instead
of per-leaf loops.

Leaf order is ``jax.tree_util`` flatten order, which **sorts dict keys**
at every level (``b0, b1, b2, w0, w1, w2`` for `make_mlp`, not its
insertion order ``w0, b0, ...``). The port keeps that order so that
every `FlatSpec` offset matches the reference column for column.
`ravel_clients` / `unravel_clients` are reshape + concatenate only, so
a round trip is exact at any dtype.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

Path = Tuple[str, ...]


class FlatSpec(NamedTuple):
    """Static flattening plan for a client-stacked parameter dict.

    ``paths[i]`` is leaf ``i``'s key path in the (possibly nested) dict
    (the port's stand-in for a JAX treedef); ``offsets[i]:offsets[i] +
    sizes[i]`` is its column range in the flat ``(N, dim)`` buffer.

    ``opt_dim`` is the per-client width of the task's local optimizer
    state, its own ``(N, opt_dim)`` plane beside the parameters'
    (momentum ``dim``, adamw ``2 * dim + 1``, plain SGD 0; see
    `repro_torch.tasks.base.opt_width`). That plane is never gossiped.
    """

    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]  # full leaf shapes, incl. client axis
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]  # per-client flat width of each leaf
    dim: int  # Dflat = sum(sizes)
    opt_dim: int = 0  # Dopt = flat width of the local optimizer state

    @property
    def num_clients(self) -> int:
        return self.shapes[0][0] if self.shapes else 0

    def with_opt(self, opt_dim: int) -> "FlatSpec":
        """The same parameter layout with an optimizer plane of width
        ``opt_dim`` beside it."""
        return self._replace(opt_dim=int(opt_dim))


def tree_items(tree, prefix: Path = ()):
    """``(path, leaf)`` pairs of a nested dict in jax flatten order
    (sorted keys at every level)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree):
    """Leaves of a nested dict in jax flatten order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_from_items(items) -> Dict[str, Any]:
    """Inverse of `tree_items`: nested dict built in sorted-key order."""
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally structured nested dicts."""
    paths = [p for p, _ in tree_items(trees[0])]
    leaves = [tree_leaves(t) for t in trees]
    return tree_from_items(
        (p, fn(*args)) for p, args in zip(paths, zip(*leaves)))


def spec_of(tree) -> FlatSpec:
    """Flattening plan for a dict whose leaves are (N, ...) tensors."""
    paths, shapes, dtypes, offsets, sizes = [], [], [], [], []
    off = 0
    for path, leaf in tree_items(tree):
        shape = tuple(leaf.shape)
        size = math.prod(shape[1:]) if len(shape) > 1 else 1
        paths.append(path)
        shapes.append(shape)
        dtypes.append(leaf.dtype)
        offsets.append(off)
        sizes.append(size)
        off += size
    return FlatSpec(tuple(paths), tuple(shapes), tuple(dtypes),
                    tuple(offsets), tuple(sizes), off)


def spec_for(params0, num_clients: int) -> FlatSpec:
    """Plan for a *single-client* dict replicated across ``num_clients``
    (the layout `protocol.init_state` produces)."""
    stacked = tree_map(
        lambda p: torch.empty((num_clients,) + tuple(p.shape), dtype=p.dtype,
                              device="meta"), params0)
    return spec_of(stacked)


def ravel_clients(tree, dtype=torch.float32) -> torch.Tensor:
    """(N, ...) dict -> contiguous (N, Dflat) matrix in ``dtype``.

    Pure reshape + concat (exact at matching dtype), leaves in jax
    flatten order, matching `spec_of`.
    """
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    return torch.cat([leaf.reshape(n, -1).to(dtype) for leaf in leaves], dim=1)


def unravel_clients(flat: torch.Tensor, spec: FlatSpec):
    """`flat` (N, Dflat) matrix -> nested dict per ``spec``, dtypes
    restored. Leaves are views of `flat` where no cast is needed. Leading
    axes of `flat` (a seed axis: (R, N, Dflat)) lead every leaf."""
    lead = tuple(flat.shape[:-2])
    return tree_from_items(
        (path, flat[..., off:off + size].reshape(lead + shape).to(dtype))
        for path, shape, dtype, off, size in zip(
            spec.paths, spec.shapes, spec.dtypes, spec.offsets, spec.sizes))

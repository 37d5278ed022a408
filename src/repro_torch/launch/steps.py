"""Step functions of the trainer (port of `repro.launch.steps`).

Only the single-device unification step is ported. The reference's
mesh train step (`make_train_step`) and the serving steps wait for
`torch.distributed` and the serving slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.flat import tree_leaves


def make_unify_step(cfg, mesh=None):
    """Periodic unification: the hub's params broadcast to every client.

    Returns ``unify_step(params, hub) -> params``. It overwrites every
    client's row with the hub's, leaf by leaf and in place (the
    reference returns a new pytree; in place, a full-size model keeps
    one copy of its parameters on the card). `hub` is an int or a
    0-d integer tensor. Only ``mesh=None`` exists so far."""
    if mesh is not None:
        raise NotImplementedError("the mesh unification step needs "
                                  "torch.distributed, which is not ported yet")

    @torch.no_grad()
    def unify_step(params, hub):
        hub = int(hub)
        for leaf in tree_leaves(params):
            row = leaf[hub].clone()
            leaf.copy_(row.expand_as(leaf))
        return params

    return unify_step

"""Gossip aggregation: ``x_j += sum_i q[i, j] * delta_i``.

Port of `repro.core.mixing`: the Psi cap on incoming edges, receive
counts, `mix_dense`, which ravels the per-client pytree to one (N,
Dflat) plane, mixes it with one launch of the gossip-mix kernel
(`kernels.gossip.ops.gossip_mix`) and unravels it back to the leaves'
dtypes, and `mix_ring_shardmap`, the cycle's mix as neighbour exchanges
between the ranks of a client mesh (`repro_torch.launch.mesh`).

All functions take dicts whose leaves have a leading client axis N (on
a mesh, the rank's clients).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import flat as flat_lib
from repro_torch.core.flat import FlatSpec
from repro_torch.kernels.gossip import ops as gossip_ops

MixFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def receive_counts(q_mask: torch.Tensor) -> torch.Tensor:
    """Messages incoming per receiver j: count of positive column entries."""
    return (q_mask > 0).sum(dim=0)


def psi_cap_mask(q: torch.Tensor, psi: int, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep at most `psi` incoming edges per receiver (column-wise top-psi
    by weight, ties broken by a uniform[0, 1e-6) draw), zeroing the rest.

    q (N, N) is (sender, receiver). The tie-break `noise` (N, N) is drawn
    from `generator` unless given (tests inject the reference's draw).
    The ranking is a stable argsort, as the reference's, so the order
    is strict even under exact ties."""
    n = q.shape[0]
    if psi >= n:
        return q
    if noise is None:
        noise = torch.rand(q.shape, generator=generator, dtype=torch.float32,
                           device=q.device) * 1e-6
    score = torch.where(q > 0, q + noise, float("-inf"))  # (sender, receiver)
    order = torch.argsort(-score, dim=0, stable=True)  # best sender first
    ranks = torch.arange(n, device=q.device)[:, None].expand(n, n)
    rank = torch.empty_like(order).scatter_(0, order, ranks)
    keep = (rank < psi) & (q > 0)
    return torch.where(keep, q, torch.zeros((), dtype=q.dtype, device=q.device))


def mix_plane(q_eff: torch.Tensor, plane: torch.Tensor,
              mix: Optional[MixFn] = None) -> torch.Tensor:
    """``Q^T @ plane`` on an already raveled (N, Dflat) plane, through the
    gossip-mix kernel (or `mix`, e.g. its plain version)."""
    return (mix or gossip_ops.gossip_mix)(q_eff, plane)


def mix_dense(q_eff: torch.Tensor, deltas):
    """x_add = Q^T @ deltas on the flat plane. q_eff (N, N) masked/weighted.

    The per-client dict is raveled to one contiguous f32 (N, Dflat)
    matrix (the reference's default compute dtype; its bf16 knob belongs
    to the mesh step), mixed by one kernel launch and unraveled back to
    the leaves' dtypes."""
    spec = flat_lib.spec_of(deltas)
    plane = flat_lib.ravel_clients(deltas, dtype=torch.float32)
    return flat_lib.unravel_clients(mix_plane(q_eff, plane), spec)


def apply_mix(params, q_eff: torch.Tensor, deltas):
    """``params + mix_dense(q_eff, deltas)``, each sum in the param's dtype
    (a new dict; `add_plane_` is the in-place form)."""
    add = mix_dense(q_eff, deltas)
    return flat_lib.tree_map(lambda p, a: p + a.to(p.dtype), params, add)


def add_plane_(params, plane: torch.Tensor, spec: FlatSpec):
    """In place, leaf by leaf: ``p += plane[:, cols(p)].to(p.dtype)``.

    The same arithmetic as `apply_mix` (the mixed f32 columns rounded to
    the leaf's dtype, then added in that dtype), but only one leaf's
    cast is alive at a time, so a full-size model needs no second copy
    of its parameters. Returns `params`."""
    leaves = flat_lib.tree_leaves(params)
    n = plane.shape[0]
    for leaf, off, size in zip(leaves, spec.offsets, spec.sizes):
        leaf.view(n, size).add_(plane[:, off:off + size].to(leaf.dtype))
    return params


# ---------------------------------------------------------------------------
# Ring lowering (cycle topology -> neighbour exchanges between ranks)
# ---------------------------------------------------------------------------


def mix_ring_shardmap(mesh, client_axes, deltas, w_fwd: float = 0.5, w_bwd: float = 0.5,
                      gate_fwd=None, gate_bwd=None):
    """Cycle gossip as neighbour exchanges on the mesh's client ranks.

    Each client receives ``w_fwd * delta_{i-1} + w_bwd * delta_{i+1}``
    (a directed ring if one weight is 0). `gate_fwd` and `gate_bwd` are
    optional (N,) per-client multipliers (event or Psi masks) applied at
    the *sender*, each cast to the leaf's dtype before the product, as in
    the reference.

    One client per rank, as the reference's ``shard_map`` body has (N ==
    client ranks): `deltas` holds this rank's client, leaves (1, ...);
    anything else raises `ValueError`. Every leaf, gated, is packed into
    one buffer per direction, and one batch of point-to-point exchanges
    (`Mesh.ring_exchange`) sends it to both neighbours and receives
    theirs. The sum is formed in each leaf's dtype, as the reference's
    is. Returns the mixed dict (this rank's client)."""
    from repro_torch.launch import mesh as mesh_lib

    axes = client_axes if isinstance(client_axes, tuple) else (client_axes,)
    if axes != mesh_lib.client_axes(mesh):
        raise ValueError(f"the ring runs over the mesh's client axes "
                         f"{mesh_lib.client_axes(mesh)}, not {axes}")
    items = flat_lib.tree_items(deltas)
    rows = {leaf.shape[0] for _, leaf in items}
    if rows != {1}:
        raise ValueError(f"the ring mix holds one client per rank (N == {mesh.size} "
                         f"client ranks); this rank holds {sorted(rows)}")
    r = mesh.rank

    def gated(gate):
        if gate is None:
            return [x for _, x in items]
        return [x * gate[r].to(x.dtype) for _, x in items]

    leaves = [x for _, x in items]
    from_prev, from_next = mesh.ring_exchange(mesh_lib.pack(gated(gate_fwd)),
                                               mesh_lib.pack(gated(gate_bwd)))
    mixed = [(w_fwd * xf + w_bwd * xb).to(x.dtype) for x, xf, xb in
             zip(leaves, mesh_lib.unpack(from_prev, leaves),
                 mesh_lib.unpack(from_next, leaves))]
    return flat_lib.tree_from_items(zip((p for p, _ in items), mixed))

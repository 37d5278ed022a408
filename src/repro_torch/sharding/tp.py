"""Tensor parallelism over the mesh's "model" axis (the port's own).

The reference lays each client's model over "model" with its sharding
rules (`repro_torch.sharding.specs`) and lets GSPMD partition the
computation. The port writes that partition out by hand, Megatron-style.
Each rank holds the block of every leaf that the leaf's spec gives it
(`block`, `shard_leaf`), and the model code computes on those blocks.
The operators below join the ranks' partial results:

  - `TP.copy`: identity forward, all-reduce of the gradient backward.
    It goes before a column-parallel product, and on a replicated leaf
    that the ranks use differently (the QKV biases, a replicated kv
    projection read by the rank's own query heads);
  - `TP.reduce`: all-reduce forward, identity backward. It goes after a
    row-parallel product, and sums the vocab-parallel embedding and
    loss;
  - `TP.gather`: all-gather forward along a dim, the rank's own slice of
    the gradient backward: for a whole computed alike on every rank (the
    served logits over the whole vocabulary);
  - `TP.gather_partial`: all-gather forward along a dim, a reduce-scatter
    of the gradient backward: for a leaf whose shard cuts an attention
    head, gathered so that each rank can slice out its own heads
    (`repro_torch.models.attention`'s padded route), and for the
    Mamba2 leaves whose block cuts across their packed parts
    (`repro_torch.models.ssm`). Each rank's gradient of the gathered
    leaf is then partial (its heads' part), so it is summed over the
    ranks and each keeps its slice.

A moe layer's expert axis sums in its own dispatch and combine
(`repro_torch.models.moe`); a Mamba2 block's gated RMSNorm sums its
squares over the ranks with ``copy(reduce(.))``, an all-reduce both
ways (`repro_torch.models.ssm`); a vlm's cross layer splits as
self-attention does, its keys and values projected from the patch
embeddings (`repro_torch.models.attention`). Every family splits over
"model". All of them run through the `Mesh`'s model collectives, so the
mesh's tally counts them (``model_all_reduce``, ``model_all_gather``,
``model_reduce_scatter``). `context`
gives None for ``mesh=None`` and for a model size of 1, and model code
given None runs the single-device path unchanged. Whether a leaf is
sharded is read off its shape against the config's (a block is narrower
than the whole), so the model code needs no spec tree.

Sequence parallelism (``seq_parallel=True``, Megatron-style; the
reference's `train_rules` laying the residual stream's 'seq' axis on
"model"). Between the sub-blocks each rank holds its S / T positions of
the residual stream (and so does a layer group's checkpointed carry),
and the joins of a sharded layer become the sequence's:

  - `TP.gather_seq`: all-gather along the sequence (dim 1) forward, a
    reduce-scatter of the gradient backward: before a column-parallel
    product, in place of `TP.copy` (each rank's gradient of the whole
    sequence is its heads' or columns' part);
  - `TP.scatter_seq`: reduce-scatter along the sequence forward, an
    all-gather of the gradient backward: after a row-parallel product,
    in place of `TP.reduce`.

`TP.enter` and `TP.leave` pick the pair of the context. A layer that a
rank computes whole (its leaves replicated) takes the whole sequence
with `TP.gather` along dim 1 and keeps its positions with `TP.split`
(the rank's slice forward, an all-gather of the gradient backward), so
that it is computed alike on every rank, as without the flag. A
replicated leaf read on the rank's positions alone (a norm's scale, the
cross layer's gate, a whole embedding's rows) gets a partial gradient
on each rank: it goes through `TP.copy` (`TP.shared`), whose backward
sums the partials. The model code runs sequence-parallel only where
the model axis divides the sequence (`TP.for_seq`); elsewhere it keeps
the residual whole, and the tally says which ran (``seq``,
``seq_whole``: a sub-block each).

The steps (`repro_torch.launch.steps`) set the context for the model
code with `use`; the model's entry points read it once (`current`) and
pass it down explicitly, so a checkpointed block recomputed during the
backward sees the same context. The serving steps also set `Rows` where
the client ranks split one batch: a moe layer's expert queues and
capacity are the whole batch's (`repro_torch.models.moe`); and a
`CacheLayout` where the decode caches lie otherwise than over the rank's
kv heads (`repro_torch.models.attention.decode_attention`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.sharding.specs import param_spec

_TLS = threading.local()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_reduce(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.n, ctx.rank = dim, x.shape[dim], mesh.model_rank
        return mesh.model_all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.mesh = dim, mesh
        return mesh.model_all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_reduce_scatter(g, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.mesh = dim, mesh
        return mesh.model_reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_gather(g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.mesh = dim, mesh
        n = x.shape[dim] // mesh.model_size
        return x.narrow(dim, mesh.model_rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_gather(g, ctx.dim), None, None


class TP:
    """This rank's place on the model axis of `mesh`: ``rank`` of
    ``size``, the operators over its model group, and whether the
    residual stream is split along the sequence (``seq``)."""

    def __init__(self, mesh, seq: bool = False):
        self.mesh = mesh
        self.rank, self.size = mesh.model_rank, mesh.model_size
        self.seq = seq

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.mesh)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _Gather.apply(x, self.mesh, dim % x.dim())

    def gather_partial(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _GatherPartial.apply(x, self.mesh, dim % x.dim())

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's positions of `x` (B, S / T, ...) along dim 1; the
        gradient summed over the ranks, each keeping its positions."""
        return _GatherPartial.apply(x, self.mesh, 1)

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' partial `x` (B, S, ...) summed, this rank's S / T
        positions kept; the gradient all-gathered."""
        return _ScatterSeq.apply(x, self.mesh, 1)

    def split(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of a whole `x` computed alike on every rank;
        the gradient all-gathered (the inverse of `gather`)."""
        return _Split.apply(x, self.mesh, dim % x.dim())

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel product: `gather_seq` under
        sequence parallelism, else `copy`."""
        return self.gather_seq(x) if self.seq else self.copy(x)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """The partial output of a row-parallel product joined:
        `scatter_seq` under sequence parallelism, else `reduce`."""
        return self.scatter_seq(x) if self.seq else self.reduce(x)

    def shared(self, leaf: torch.Tensor) -> torch.Tensor:
        """A replicated leaf as the rank reads it: through `copy` under
        sequence parallelism (read on the rank's positions, its gradient
        is their part), else itself."""
        return self.copy(leaf) if self.seq else leaf

    def positions(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's S / T positions (dim 1) of an input alike on every
        rank, outside autograd (tokens, frame embeddings)."""
        n = x.shape[1] // self.size
        return x.narrow(1, self.rank * n, n)

    def for_seq(self, S: int) -> "TP":
        """The context for a sequence of `S` positions: this one, or
        without sequence parallelism where the model axis does not divide
        `S` (the residual kept whole, as the reference's
        `filter_divisible` drops the constraint)."""
        if self.seq and S % self.size:
            return TP(self.mesh, seq=False)
        return self

    def count_seq(self, split: bool) -> None:
        """Tally one sub-block run with the residual split along the
        sequence (`split`) or kept whole where the flag asked to split."""
        self.mesh.tp_routes["seq" if split else "seq_whole"] += 1

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the model ranks, outside autograd."""
        return self.mesh.model_all_reduce(x.detach(), op="max")

    def count(self, route: str, leaves: int = 0) -> None:
        """Tally one attention layer on `route`, and the leaves it gathered."""
        self.mesh.tp_routes[route] += 1
        self.mesh.tp_routes["gathered_leaves"] += leaves

    def count_moe(self, experts: int) -> None:
        """Tally one moe layer, and the experts the rank runs in it."""
        self.mesh.tp_routes["moe"] += 1
        self.mesh.tp_routes["experts"] = experts

    def count_ssm(self, heads: int, leaves: int = 0) -> None:
        """Tally one Mamba2 block, the ssm heads the rank computes in it,
        and the leaves it gathered."""
        self.mesh.tp_routes["ssm"] += 1
        self.mesh.tp_routes["ssm_heads"] = heads
        self.mesh.tp_routes["gathered_leaves"] += leaves


class Rows:
    """This rank's place among the client ranks of `mesh` when they split
    one batch (the serving steps): ``rank`` of ``size``, each holding as
    many rows. A moe layer ranks its tokens' expert choices among the
    whole batch's (`gather`), as the reference's layer does over its
    global batch."""

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def size(self) -> int:
        return self.mesh.size

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every client rank's `x` concatenated along dim 0, in rank order."""
        return self.mesh.all_gather(x, 0)


class CacheLayout(NamedTuple):
    """Where a served model's KV caches lie over the ranks of ``mesh``
    beyond their batch rows: the reference's `serve_shardings` cache spec
    after `filter_divisible` (`repro_torch.launch.steps.cache_layout`
    makes it).

      - ``slots``: the mesh axis the cache's slots split over: "data" (a
        served batch that does not divide by the client ranks, whole on
        each of them: the reference's long-context layout; on a mesh with
        "pod", the "data" ranks of one pod), "model" (``cache_shard=
        "seq"``) or None. A rank holds the slots ``index * C / parts`` on
        (`slot_block`);
      - ``head_dim``: the cache's head_dim split over "model"
        (``cache_shard="head_dim"``), the rank's block ``model_rank * hd /
        T`` on;
      - ``every_head``: the cache holds every kv head (``cache_shard``
        "head_dim" or "seq" on a "model" axis larger than 1, also where
        `filter_divisible` keeps that cache whole); else the kv heads the
        rank computes (`repro_torch.models.attention.rank_heads`).

    ``memo`` keeps what the decode steps under the layout make once (the
    heads' indices on each device)."""
    mesh: object
    slots: Optional[str]
    head_dim: bool
    every_head: bool
    memo: dict

    def slot_block(self) -> tuple:
        """``(index, parts)``: this rank's block of the slots."""
        if self.slots == "data":
            return getattr(self.mesh, "data_rank", 0), self.mesh.shape["data"]
        if self.slots == "model":
            return self.mesh.model_rank, self.mesh.model_size
        return 0, 1

    def hd_block(self) -> tuple:
        """``(index, parts)``: this rank's block of head_dim."""
        return (self.mesh.model_rank, self.mesh.model_size) if self.head_dim else (0, 1)

    def slot_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """`x` reduced (``"sum"`` or ``"max"``) over the ranks that hold the
        other blocks of the slots."""
        if self.slots == "data":
            return self.mesh.client_all_reduce(x, op)
        return self.mesh.model_all_reduce(x, op)

    def describe(self) -> dict:
        """The layout as the dry run's row records it."""
        return {"slots": self.slots, "head_dim": "model" if self.head_dim else None,
                "kv_heads": "every" if self.every_head else "the rank's"}


def context(mesh, seq_parallel: bool = False) -> Optional[TP]:
    """The `TP` of `mesh`, or None for no mesh or a model size of 1;
    `seq_parallel` splits the residual stream along the sequence."""
    if mesh is None or getattr(mesh, "model_size", 1) == 1:
        return None
    return TP(mesh, seq=seq_parallel)


def rows_context(mesh) -> Optional[Rows]:
    """The `Rows` of `mesh`, or None for no mesh or one client rank."""
    if mesh is None or mesh.size == 1:
        return None
    return Rows(mesh)


def current() -> Optional[TP]:
    return getattr(_TLS, "tp", None)


def current_rows() -> Optional[Rows]:
    return getattr(_TLS, "rows", None)


def current_cache() -> Optional[CacheLayout]:
    return getattr(_TLS, "cache", None)


@contextlib.contextmanager
def use(tp: Optional[TP], rows: Optional[Rows] = None, cache: Optional[CacheLayout] = None):
    """Make `tp` (and `rows`, for a batch split over the client ranks, and
    `cache`, the decode caches' layout) the model code's context
    (`current`, `current_rows`, `current_cache`) inside the block."""
    prev = getattr(_TLS, "tp", None), getattr(_TLS, "rows", None), getattr(_TLS, "cache", None)
    _TLS.tp, _TLS.rows, _TLS.cache = tp, rows, cache
    try:
        yield tp
    finally:
        _TLS.tp, _TLS.rows, _TLS.cache = prev


# ---------------------------------------------------------------------------
# Blocks of leaves
# ---------------------------------------------------------------------------


def _axis_index(mesh, ax) -> int:
    from repro_torch.launch import mesh as mesh_lib

    caxes = mesh_lib.client_axes(mesh)
    if ax == "model":
        return mesh.model_rank
    if ax == (caxes if len(caxes) > 1 else caxes[0]):
        return mesh.rank
    raise ValueError(f"no rank index of mesh axis {ax!r} (client axes {caxes})")


def _axis_size(mesh, ax) -> int:
    names = ax if isinstance(ax, tuple) else (ax,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of `t` under `spec` (a view): along each dim laid
    over mesh axes, its share at its index on them."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            k = t.shape[dim] // _axis_size(mesh, ax)
            t = t.narrow(dim, _axis_index(mesh, ax) * k, k)
    return t


def local_shape(spec, shape, mesh) -> tuple:
    """The shape of one rank's block of a `shape` leaf under `spec`."""
    return tuple(d if ax is None else d // _axis_size(mesh, ax)
                 for d, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def shard_leaf(path, leaf: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's model block of one leaf of `M.init_params` as it is
    made (a single client's leaf, or one layer group's slice of a
    stacked one: the rules' core dims are its last dims either way), a
    copy of its own, so that the whole leaf can be freed (a block of
    leading rows is contiguous already: a view would keep the whole
    leaf's storage alive)."""
    spec = param_spec(path, tuple(leaf.shape), mesh)
    b = block(leaf, spec, mesh)
    return b.contiguous() if b.numel() == leaf.numel() else \
        b.clone(memory_format=torch.contiguous_format)


def sharder(mesh):
    """`M.init_params`' ``shard`` for this rank of `mesh` (`shard_leaf`),
    or None without a "model" axis larger than 1."""
    if context(mesh) is None:
        return None
    return lambda path, leaf: shard_leaf(path, leaf, mesh)

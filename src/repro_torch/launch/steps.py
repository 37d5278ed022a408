"""Step functions of the trainer and the server, and their abstract
inputs (port of `repro.launch.steps`).

``make_train_step``: one DRACO superposition window on a mesh
(`repro_torch.launch.mesh`): each rank holds N / D clients of the D
client ranks, each as its block of the model over the T ranks of
"model" (`repro_torch.sharding.tp`; every family), runs their local
gradient steps
(`train.train_step_clients`), forms Delta on its rows and columns of the
f32 plane, and the row-stochastic gossip mix runs as a collective over
the client ranks of its model index (a column block of the plane mixes
on its own). Event and channel masks arrive as the per-window effective
Q (``q_eff``), drawn N-wide and alike on every rank.

``make_unify_step`` is the trainer's periodic unification;
``serve_config``, ``make_prefill_step`` and ``make_serve_step`` are
serving's: prefill a full prompt (the flash path at S >= 8192) and
decode one token against a KV/SSM cache, on the unified model (one copy
of the parameters). Each takes ``mesh=None`` for one device.

The abstract inputs (``train_batch_specs``, ``serve_input_specs``,
``param_specs_abstract``, ...) are tensors on ``torch.device("meta")``:
shapes and dtypes, no memory. The dtypes are the port's own: tokens and
labels are int64 (the reference's int32), embeddings ``cfg.dtype``.
``make_shardings`` and ``serve_shardings`` return the matching trees of
`PartitionSpec`s, the layout the reference's ``NamedSharding``s give;
`local_abstract` turns abstract parameters and their specs into one
rank's blocks, the shapes the steps take on that rank.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import flat as flat_lib
from repro_torch.core import mixing
from repro_torch.kernels.gossip import ops as gossip_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.specs import PartitionSpec as P
from repro_torch.sharding.specs import filter_divisible, tree_param_specs


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads meta: `M.init_params` draws
    on its generator's device, so it lays out meta tensors."""

    @property
    def device(self):
        return torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, n_clients: int):
    """Per-client-stacked batch: leaves lead with (N, b, ...)."""
    if shape.global_batch % n_clients:
        raise ValueError(f"global batch {shape.global_batch} does not divide by "
                         f"{n_clients} clients")
    b, S = shape.global_batch // n_clients, shape.seq_len
    specs: Dict[str, Any] = {}
    if cfg.embeds_in:
        specs["embeds"] = _meta((n_clients, b, S, cfg.d_model), cfg.torch_dtype)
        specs["labels"] = _meta((n_clients, b, S), torch.int64)
    else:
        specs["tokens"] = _meta((n_clients, b, S), torch.int64)
    if cfg.family == "vlm":
        specs["cross_embeds"] = _meta((n_clients, b, cfg.num_patch_tokens, cfg.d_model),
                                      cfg.torch_dtype)
    return specs


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Decode-step inputs: current token + cache state (+ cross KV), whole."""
    B, S = shape.global_batch, shape.seq_len
    serve_cfg = serve_config(cfg, shape)
    state = M.init_decode_state(serve_cfg, B, S, device="meta")
    if cfg.embeds_in:
        tok = _meta((B, 1, cfg.d_model), cfg.torch_dtype)
    else:
        tok = _meta((B,), torch.int64)
    cross = None
    if cfg.family == "vlm":
        pe = _meta((B, cfg.num_patch_tokens, cfg.d_model), cfg.torch_dtype)
        cross = M.init_cross_kv(param_specs_abstract(serve_cfg), serve_cfg, pe)
    return tok, state, cross


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if cfg.embeds_in:
        specs["embeds"] = _meta((B, S, cfg.d_model), cfg.torch_dtype)
    else:
        specs["tokens"] = _meta((B, S), torch.int64)
    if cfg.family == "vlm":
        specs["cross_embeds"] = _meta((B, cfg.num_patch_tokens, cfg.d_model), cfg.torch_dtype)
    return specs


def param_specs_abstract(cfg: ModelConfig):
    """One client's parameters as meta tensors (`M.init_params`' layout)."""
    return M.init_params(_MetaGenerator(), cfg)


def stack_clients_abstract(params_abs, n_clients: int):
    return flat_lib.tree_map(lambda l: _meta((n_clients,) + tuple(l.shape), l.dtype),
                             params_abs)


def serve_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Serving variant: at long_500k the attention families (and the
    hybrid's shared attention) get a sliding window of 8192, a ring
    cache; ssm decodes in O(1) as it is."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm", "audio"):
        return cfg.with_(sliding_window=8192)
    if shape.name == "long_500k" and cfg.family == "hybrid":
        return cfg.with_(sliding_window=8192)
    return cfg


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------


def _client_ax(mesh):
    caxes = mesh_lib.client_axes(mesh)
    return caxes if len(caxes) > 1 else caxes[0]


def local_abstract(params, specs, mesh):
    """One rank's blocks of the abstract (meta) parameter dict `params`
    under the matching `specs` (`make_shardings`' or `serve_shardings`'):
    the shapes a step takes on that rank."""
    return flat_lib.tree_map(
        lambda t, s: _meta(tp_lib.local_shape(s, tuple(t.shape), mesh), t.dtype), params, specs)


def make_shardings(mesh, cfg: ModelConfig, shape: ShapeConfig):
    """(param specs (client-stacked), batch specs, q spec): every client
    leaf and batch leaf laid over the client axes on its first dim, Q
    replicated; the params' core dims over "model" by the rules of
    `repro_torch.sharding.specs` (`local_abstract` gives a rank's
    shapes)."""
    cax = _client_ax(mesh)
    n_clients = mesh_lib.num_clients(mesh)
    params_abs = stack_clients_abstract(param_specs_abstract(cfg), n_clients)
    pspecs = tree_param_specs(params_abs, prefix=(cax,), mesh=mesh)
    bspecs = {name: P(cax, *([None] * (t.dim() - 1)))
              for name, t in train_batch_specs(cfg, shape, n_clients).items()}
    return pspecs, bspecs, P(None, None)


def _map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a tree of dicts and named tuples (a
    `DecodeState`), keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    return fn(path, tree)


CACHE_SHARDS = ("kv_heads", "head_dim", "seq")


def _rows_split(shape: ShapeConfig, mesh) -> bool:
    """Whether a served batch splits over the client ranks of `mesh`: where
    it divides by them. Else it stays whole on every client rank and the
    cache's slots go over "data" (the reference's long-context layout;
    "data" alone on a mesh with "pod")."""
    return shape.global_batch % _client_ranks(mesh) == 0


def _client_ranks(mesh) -> int:
    return getattr(mesh, "size", None) or mesh_lib.num_clients(mesh)


def _kv_spec(cache_shard: str, batch_ax, seq_ax):
    """The reference's spec of a KV cache leaf (n_groups, B, C, Hkv, hd)."""
    if cache_shard == "head_dim":
        return P(None, batch_ax, seq_ax, None, "model")
    if cache_shard == "seq":
        return P(None, batch_ax, "model", None, None)
    return P(None, batch_ax, seq_ax, "model", None)


def serve_shardings(mesh, cfg: ModelConfig, shape: ShapeConfig,
                    cache_shard: str = "kv_heads"):
    """Specs for (params single-copy, token, decode state, cross_kv) and
    the serving config.

    cache_shard: 'kv_heads' shards the KV-head axis over "model" (falls
    back to replicated when it does not divide); 'head_dim' the head_dim
    axis, 'seq' the cache length axis. A batch that does not divide by the
    client ranks stays whole on each of them and shards the cache's
    sequence axis over "data" instead (not under 'seq', which puts it on
    "model"). The port's serve step lays its caches so (`cache_layout`,
    `M.init_decode_state` with it), except that where "model" does not
    divide the kv heads under 'kv_heads' a rank holds the kv heads its
    query heads read, where the reference replicates them all. A vlm's
    cross K/V takes the reference's spec, its rows over the client axes
    and its kv heads over "model" where they divide; where they do not,
    the reference replicates them and a rank of the port holds the kv
    heads its query heads read (`M.init_cross_kv` with the mesh), as its
    KV cache does."""
    batch_ax, seq_ax = (_client_ax(mesh), None) if _rows_split(shape, mesh) else (None, "data")
    scfg = serve_config(cfg, shape)
    pspecs = tree_param_specs(param_specs_abstract(scfg), prefix=(), mesh=mesh)
    tok, state, cross = serve_input_specs(cfg, shape)
    tok_spec = P(batch_ax, None, None) if cfg.embeds_in else P(batch_ax)

    def cache_spec(path, leaf):
        name = "/".join(str(p) for p in path)
        nd = leaf.dim()
        if nd == 0:
            spec = P()
        elif "ssm" in name and nd == 4:  # conv state (n_groups, B, W-1, ch)
            spec = P(None, batch_ax, None, "model")
        elif "ssm" in name and nd == 5:  # h (n_groups, B, H, N, P)
            spec = P(None, batch_ax, "model", None, None)
        elif nd == 5:  # KV cache (n_groups, B, C, Hkv, hd)
            spec = _kv_spec(cache_shard, batch_ax, seq_ax)
        else:
            spec = P(*([None] * nd))
        return filter_divisible(spec, tuple(leaf.shape), mesh)

    state_specs = _map_with_path(cache_spec, state)
    cross_specs = None
    if cross is not None:
        cross_specs = flat_lib.tree_map(
            lambda l: filter_divisible(P(None, batch_ax, None, "model", None),
                                       tuple(l.shape), mesh), cross)
    return pspecs, tok_spec, state_specs, cross_specs, scfg


def serving_rows(shape: ShapeConfig, mesh) -> int:
    """The rows of a served batch a client rank of `mesh` holds: its share
    where the batch divides by the client ranks, else the whole batch."""
    B = shape.global_batch
    if mesh is None or not _rows_split(shape, mesh):
        return B
    return B // _client_ranks(mesh)


def cache_layout(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 cache_shard: str = "kv_heads") -> Optional[tp_lib.CacheLayout]:
    """How the serve step of `shape` on `mesh` lays its KV caches under
    `cache_shard` (`CACHE_SHARDS`): the reference's KV spec
    (`serve_shardings`) after `filter_divisible`, as a
    `repro_torch.sharding.tp.CacheLayout`; None for the port's default
    (no mesh, or the rank's kv heads at every slot) and for a model
    without a KV cache (mamba2). A 1-way axis splits nothing."""
    if cache_shard not in CACHE_SHARDS:
        raise ValueError(f"cache_shard {cache_shard!r} not in {CACHE_SHARDS}")
    model = mesh is not None and getattr(mesh, "model_size", 1) > 1
    pattern, _ = M.block_pattern(cfg)
    if mesh is None or not model and _rows_split(shape, mesh) or not (
            {"attn", "shared"} & set(pattern)):
        return None  # nothing to lay out otherwise, or no KV cache at all
    scfg = serve_config(cfg, shape)
    ring = scfg.sliding_window > 0 and shape.seq_len > scfg.sliding_window
    C = scfg.sliding_window if ring else shape.seq_len
    hd = cfg.resolved_head_dim if cfg.num_heads else 1
    kv = (1, shape.global_batch, C, max(cfg.num_kv_heads, 1), hd)
    seq_ax = None if _rows_split(shape, mesh) else "data"
    spec = tuple(filter_divisible(_kv_spec(cache_shard, None, seq_ax), kv, mesh))
    slots = spec[2] if spec[2] == "data" and mesh.shape["data"] > 1 or \
        spec[2] == "model" and model else None
    head_dim, every = spec[4] == "model" and model, cache_shard != "kv_heads" and model
    if slots is None and not head_dim and not every:
        return None
    return tp_lib.CacheLayout(mesh, slots, head_dim, every, {})


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def depth_config(cfg: ModelConfig, k: int) -> ModelConfig:
    """Same width, depth reduced to k layer-groups."""
    _, n_groups = M.block_pattern(cfg)
    unit = cfg.num_layers // n_groups
    return cfg.with_(num_layers=unit * k)


MIX_MODES = ("dense", "ring", "none")


def mesh_mix(mesh, mix_mode: str = "dense", mix_dtype: Optional[torch.dtype] = None,
             spec: Optional[flat_lib.FlatSpec] = None) -> mixing.MixFn:
    """The mix of `make_train_step` as a `mixing.MixFn` on this rank's
    rows: ``mix(q_eff (N, N), plane (N_loc, Dflat) f32) -> (N_loc, Dflat)
    f32``.

    'dense': `gossip_drain_sharded` with one bucket, this rank's sender
    rows of ``q_eff`` against every receiver: the drain kernel's
    rectangular route on the rank's plane, then one reduce-scatter. The
    reference all-gathers the plane and multiplies locally; the same
    contraction, the same bytes across ranks. ``mix_dtype=torch.bfloat16``
    rounds ``q_eff`` and the plane to bf16, as the reference's bf16 mix
    does, and sends the partials in bf16 (half the bytes).
    'ring': `mixing.mix_ring_shardmap` on the plane's leaves in their own
    dtypes (`spec` gives them: this rank's `FlatSpec`); it ignores
    ``q_eff``, as the reference's ring mode does, and takes one client
    per rank. 'none': the plane itself, no collective."""
    if mix_mode not in MIX_MODES:
        raise ValueError(f"mix_mode {mix_mode!r} not in {MIX_MODES}")
    md = mix_dtype or torch.float32
    caxes = mesh_lib.client_axes(mesh)

    def dense(q_eff, plane):
        w = q_eff[mesh.client_slice(q_eff.shape[0])].to(md).float()
        return gossip_ops.gossip_drain_sharded(w[None], plane.to(md)[None], [0], mesh,
                                               caxes, collective_dtype=md)

    def ring(q_eff, plane):
        mixed = mixing.mix_ring_shardmap(mesh, caxes, flat_lib.unravel_clients(plane, spec))
        return flat_lib.ravel_clients(mixed, dtype=torch.float32)

    def none(q_eff, plane):
        return plane

    if mix_mode == "ring" and spec is None:
        raise ValueError("the ring mix needs the rank's FlatSpec")
    return {"dense": dense, "ring": ring, "none": none}[mix_mode]


def make_train_step(cfg: ModelConfig, mesh, *, lr: float = 1e-3,
                    mix_mode: str = "dense", psi: int = 0, mix_dtype=None,
                    blocked_threshold: int = 8192, vocab_chunk: int = 0,
                    seq_parallel: bool = False):
    """One DRACO window on the client mesh: local grad -> Delta -> gossip
    mix -> apply. Returns ``train_step(params, batch, q_eff) -> (params,
    loss)``.

    params and batch hold this rank's clients (``mesh.client_slice(N)``
    of the N-wide ones), the params as the rank's blocks of them
    (`make_shardings`; `repro_torch.convert.shard_params` or
    `train.init_client_params` with the mesh make them); q_eff (N, N) is
    the whole window's weights, alike on every rank. The step is `train.train_step_clients` over the
    rank's clients with `mesh_mix`'s mix (`mix_mode` 'dense', 'ring' or
    'none'; `mix_dtype` the dense mix's dtype); params are updated in
    place. The loss is the mean over all N clients (the ranks' per-client
    losses gathered in client order), a 0-d tensor on every rank. The
    Psi cap lives in ``q_eff`` (`train.mixing_weights`); `psi` is the
    reference's argument, which its step does not read either.
    `blocked_threshold` and `vocab_chunk` go to `M.lm_loss`. On a
    "model" axis larger than 1 an attention layer (a vlm's cross layer
    too) computes the rank's own query heads, a Mamba2 block its own ssm
    heads (`repro_torch.models.ssm`); a vlm's ``cross_embeds`` and an
    audio model's ``embeds`` hold the rank's clients' rows, whole over
    "model". `seq_parallel` lays the residual stream's sequence over
    "model" (the reference's `train_rules(seq_parallel=True)`): each
    rank holds S / T positions of it between the layers
    (`repro_torch.sharding.tp`), where T divides S; the numbers are the
    same. The serving steps take no such flag, as the reference's dry
    run passes it to the train step alone."""
    from repro_torch.launch import train as train_lib

    if mix_mode not in MIX_MODES:
        raise ValueError(f"mix_mode {mix_mode!r} not in {MIX_MODES}")
    del psi

    tp = tp_lib.context(mesh, seq_parallel=seq_parallel)

    def train_step(params, batch, q_eff):
        mix = mesh_mix(mesh, mix_mode, mix_dtype, flat_lib.spec_of(params))
        with tp_lib.use(tp):
            params, losses = train_lib.train_step_clients(
                params, batch, q_eff, cfg, lr, mix=mix,
                blocked_attn_threshold=blocked_threshold, vocab_chunk=vocab_chunk)
        return params, mesh.all_gather(losses).mean()

    return train_step


def make_unify_step(cfg, mesh=None):
    """Periodic unification: the hub's params broadcast to every client.

    Returns ``unify_step(params, hub) -> params``. It overwrites every
    client's row with the hub's, leaf by leaf and in place (the
    reference returns a new pytree; in place, a full-size model keeps
    one copy of its parameters on the card). `hub` is an int or a 0-d
    integer tensor. On a mesh, params hold this rank's clients; the rank
    that holds the hub sends its row, every leaf packed in one buffer,
    in one broadcast, and every rank writes it into all its rows."""

    @torch.no_grad()
    def unify_step(params, hub):
        # repro-lint: disable-next-line=HOST-SYNC-IN-HOT-PATH(the trainer passes its rotating hub as a host int, which reads nothing; a 0-d tensor, the reference's argument, costs one read per unification, not per step)
        hub = int(hub)
        leaves = flat_lib.tree_leaves(params)
        if mesh is None:
            rows = [leaf[hub].clone() for leaf in leaves]
        else:
            n_loc = leaves[0].shape[0]
            src = mesh.owner(hub, n_loc * mesh.size)
            local = hub - src * n_loc if src == mesh.rank else 0
            rows = mesh.broadcast_tensors([leaf[local] for leaf in leaves], src)
        for leaf, row in zip(leaves, rows):
            leaf.copy_(row.expand_as(leaf))
        return params

    return unify_step


def _prefill_rows(shape: ShapeConfig, mesh) -> None:
    if mesh is not None and not _rows_split(shape, mesh):
        raise ValueError(
            f"the prefill lays its batch over the {_client_ranks(mesh)} client ranks, as the "
            f"reference's in_shardings (P(client axes, None)) do; a batch of "
            f"{shape.global_batch} does not divide, which jax refuses when it lowers the "
            f"reference's prefill, and so does the port")


def _whole_vocab(logits, cfg, tp):
    """The logits over the whole vocabulary: the rank's block gathered
    over the model ranks when it is one."""
    if tp is None or logits.shape[-1] == cfg.vocab_size:
        return logits
    return tp.gather(logits)


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """``prefill_step(params, batch) -> logits (B, V)`` at the last
    position: `apply_model` under `serve_config`, without gradients. On
    a mesh each rank prefills its ``mesh.client_slice(B)`` rows of the
    batch with its blocks of the one copy of the params
    (`serve_shardings`) and returns their logits over the whole
    vocabulary, gathered over "model" as the reference's are. A moe
    layer ranks its tokens' expert choices among the whole batch's
    (`repro_torch.sharding.tp.Rows`), as the reference's does; a Mamba2
    block computes the rank's own ssm heads; a vlm's cross layer its own
    query heads against the rank's rows of ``cross_embeds``. A batch
    that does not divide by the client ranks raises `ValueError`, as the
    reference's lowering does."""
    _prefill_rows(shape, mesh)
    scfg = serve_config(cfg, shape)
    tp, rows = tp_lib.context(mesh), tp_lib.rows_context(mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        with tp_lib.use(tp, rows):
            logits, _ = M.apply_model(params, scfg, batch)
        return _whole_vocab(logits[:, -1, :], scfg, tp)

    return prefill_step


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                    cache_shard: str = "kv_heads"):
    """``serve_step(params, tok, state, cross_kv=None) -> (logits, state)``:
    one `decode_step` under `serve_config` (its caches updated in place).
    On a mesh each rank decodes its ``serving_rows(shape, mesh)`` rows (its
    ``mesh.client_slice(B)`` where the batch divides by the client ranks,
    else the whole batch on every client rank) with its blocks of the
    params (`serve_shardings`): `tok`, `state` and `cross_kv` hold those
    rows, the state from ``init_decode_state(scfg, rows, S, mesh=mesh,
    layout=cache_layout(cfg, shape, mesh, cache_shard))`` (the step's
    ``layout``): its KV caches as `cache_layout` says (by default the
    rank's kv heads where "model" divides them, at every slot; the rank's
    block of the slots over "data" where the batch does not divide; every
    kv head at the rank's block of head_dim or of the slots over "model"
    under ``cache_shard`` 'head_dim' or 'seq'), its ssm heads and their
    conv channels. The logits are those rows' over the whole vocabulary,
    gathered over "model". A vlm's `cross_kv` holds the rank's rows and
    kv heads (``init_cross_kv(params, scfg, cross_embeds, mesh)``); an
    audio model's `tok` is its rows' embeddings, whole over "model"
    (`M.token_embeds` with the mesh for a fed-back token). A moe layer
    ranks its expert queues over the whole batch, split over the client
    ranks (`tp_lib.Rows`) or whole on each. On a mesh a state whose KV
    caches are laid out otherwise raises `ValueError`."""
    tp = tp_lib.context(mesh)
    layout = cache_layout(cfg, shape, mesh, cache_shard)
    rows = None if serving_rows(shape, mesh) == shape.global_batch else \
        tp_lib.rows_context(mesh)
    scfg = serve_config(cfg, shape)
    want = None
    if mesh is not None:
        meta = M.init_decode_state(scfg, 1, shape.seq_len, device="meta", mesh=mesh,
                                   layout=layout)
        want = {name: tuple(c.k.shape[2:]) for name, c in meta.caches.items()
                if hasattr(c, "k")}

    def serve_step(params, tok, state, cross_kv=None):
        if want is not None:
            got = {name: tuple(state.caches[name].k.shape[2:]) for name in want}
            if got != want:
                raise ValueError(f"the state's KV caches are (slots, kv heads, head_dim) "
                                 f"{got}; the serve step's layout ({cache_shard}) lays "
                                 f"them {want}")
        with tp_lib.use(tp, rows, layout):
            logits, state = M.decode_step(params, scfg, tok, state, cross_kv)
        return _whole_vocab(logits, scfg, tp), state

    serve_step.layout = layout
    return serve_step

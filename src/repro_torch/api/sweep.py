"""`simulate_sweep`: a whole (config x scenario) x seed grid in one call.

Port of `repro.api.sweep`. The paper's headline figures are statements
about sweeps (Fig. 4 is accuracy against Psi over seeds), so one call
runs the grid along three axes over the driver loop of
`repro_torch.api.simulate`:

  - **seed axis.** Each seed's state is made by its own solo `init`. An
    algorithm with a `seed_axis` (``draco``, ``fedasync-window``) stacks
    them into one state with a leading R axis (`protocol.stack_seeds`)
    and advances all R seeds in one pass per window: one drain launch
    (the drain kernel's seed axis), the local step over R * N client
    rows, the channel, Psi and unification on the stacked tensors, each
    seed drawing from its own generator as its solo run does. The
    others (the baselines, the event family) run the seeds one solo
    state after another. Row r is the solo `simulate` run with seed r
    (exactly on the CPU; on the card the batched local step's GEMMs may
    round differently from the solo ones).
  - **config axis.** Grid configs may differ only in the sweepable
    fields (`lr`, `lambda_grad`, `lambda_tx`, `psi`, those the algorithm
    declares in `sweepable`); `stack_configs` splits them into the base
    config and `Overrides` of per-row values, re-bound on the context
    row by row. Rows run one after another on the host (the reference
    scans them, which is sequential too), so an override is a Python
    number and row g equals the solo run with ``cfg.replace(...)``.
  - **scenario axis.** A list of same-shape `Schedule`s, one per grid
    row.

Client-axis sharding: pass ``mesh=`` (a `repro_torch.launch.mesh.Mesh`,
e.g. ``make_sweep_mesh(backend=...)``, one per rank of a world that runs
the same call) and each rank holds N / ranks of the clients
(`shard_grid_inputs`): its rows of the states and of the federated data
shards. Every window drains through
`repro_torch.kernels.gossip.ops.gossip_drain_sharded` (each rank's
rectangular drain, one reduce-scatter over the receiver axis) and
unifies by a broadcast from the hub's rank; the draws, the channel and
Psi run N-wide on every rank; evaluation gathers every client's params.
The finals are gathered N-wide on every rank, so a rank's result equals
the unsharded call's up to f32 summation order. ``draco`` only: the
other algorithms raise (ROADMAP item 21).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.algorithm import Algorithm, get_algorithm
from repro_torch.api.algorithms import Draco
from repro_torch.api.context import SimContext, make_context
from repro_torch.api.simulate import SimTrace, _run, resolve_workload
from repro_torch.core import flat as flat_lib
from repro_torch.core.protocol import (Overrides, gather_state, shard_state, stack_draws,
                                       stack_seeds)

ROADMAP_MESH_BASELINES = "ROADMAP item 21"

# Config fields the engine knows how to re-bind per grid row. An algorithm
# declares which of these it consumes (`sweepable`); sweeping a field it
# ignores would return G identical rows, so that is rejected.
SWEEPABLE = ("lr", "lambda_grad", "lambda_tx", "psi")
_OVERRIDE_TYPES = {"lr": float, "lambda_grad": float, "lambda_tx": float, "psi": int}


class SweepTrace(NamedTuple):
    """Grid-shaped metric trace of one `simulate_sweep` call.

    `step` is shared by every cell (one cadence everywhere); each metric
    is ``(G, R, num_evals)``: grid rows x seeds x eval points."""

    step: np.ndarray  # (num_evals,) int32
    metrics: Dict[str, np.ndarray]  # each (G, R, num_evals)


def stack_configs(cfg_grid: Sequence) -> tuple:
    """Split a config grid into ``(base_cfg, Overrides)``.

    Every config must equal the first once its sweepable fields are set
    to the first's; a field that varies becomes a ``(G,)`` tuple of the
    rows' values in the `Overrides`, a constant one stays None."""
    cfgs = list(cfg_grid)
    if not cfgs:
        raise ValueError("empty config grid")
    base = cfgs[0]
    varying = {}
    for f in SWEEPABLE:
        vals = [getattr(c, f) for c in cfgs]
        if any(v != vals[0] for v in vals):
            varying[f] = tuple(_OVERRIDE_TYPES[f](v) for v in vals)
    norm = {f: getattr(base, f) for f in varying}
    for i, c in enumerate(cfgs):
        if c.replace(**norm) != base:
            bad = [f for f in c.__dataclass_fields__
                   if f not in varying and getattr(c, f) != getattr(base, f)]
            raise ValueError(
                f"cfg_grid[{i}] differs from cfg_grid[0] in non-sweepable "
                f"field(s) {bad}; only {SWEEPABLE} can vary inside one "
                "sweep — split the grid or loop host-side")
    return base, Overrides(**varying)


def row_overrides(overrides: Overrides, g: int) -> Optional[Overrides]:
    """Grid row `g`'s `Overrides` of Python numbers (None when nothing
    varies)."""
    if all(v is None for v in overrides):
        return None
    return Overrides(*(None if v is None else v[g] for v in overrides))


def stack_schedules(schedules: Sequence) -> list:
    """Check that same-shape `Schedule`s can share a grid (the same fields
    present, the same ring shapes) and return them as a list, one per
    grid row."""
    scheds = list(schedules)
    structs = {tuple((name, None if ring is None else tuple(ring.shape))
                     for name, ring in zip(type(s)._fields, s)) for s in scheds}
    if len(structs) > 1:
        raise ValueError(
            "schedules must share one pytree structure (same fields "
            f"present, same ring periods); got {len(structs)} distinct")
    return scheds


def seed_keys(key, num_seeds: int) -> list:
    """`num_seeds` int seeds from one `key`: an int seeds a numpy
    `SeedSequence`, a `torch.Generator` draws them."""
    if isinstance(key, torch.Generator):
        return [int(s) for s in torch.randint(0, 2 ** 31 - 1, (num_seeds,), generator=key,
                                              device=key.device).tolist()]
    return [int(s) for s in np.random.SeedSequence(int(key)).generate_state(num_seeds)]


def _stack(values):
    """Stack equally structured run outputs on a new leading axis:
    tensors with `torch.stack`, numbers into numpy arrays, dicts and
    tuples element by element, generators (and a seed-stacked state's
    tuple of them) as a tuple."""
    v0 = values[0]
    if isinstance(v0, torch.Tensor):
        return torch.stack(values)
    if isinstance(v0, dict):
        return {k: _stack([v[k] for v in values]) for k in v0}
    if isinstance(v0, tuple) and not all(isinstance(x, torch.Generator) for x in v0):
        parts = (_stack(list(f)) for f in zip(*values))
        return type(v0)(*parts) if hasattr(v0, "_fields") else tuple(parts)
    if v0 is None:
        return None
    if isinstance(v0, (int, float, np.number, np.ndarray)):
        return np.asarray(values)
    return tuple(values)


def _copy(v):
    """A fresh copy of a state: tensors cloned, generators at the same
    point of their streams."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, torch.Generator):
        g = torch.Generator(device=v.device)
        g.set_state(v.get_state())
        return g
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_copy(x) for x in v))
    if isinstance(v, tuple):
        return tuple(_copy(x) for x in v)
    return v


class _MeshDraco(Draco):
    """`draco` on a client mesh: each window on this rank's client slice
    (`draco_window`'s `mesh`), evaluation on every client's params."""

    name = "draco"

    def __init__(self, mesh):
        self.mesh = mesh

    def eval_params(self, state):
        return flat_lib.tree_map(self.mesh.all_gather, state.params)


def _client_sharding(x, num_clients: int, mesh):
    """The index that keeps this rank's clients of `x`: its first axis of
    size `num_clients`, sliced to ``mesh.client_slice(num_clients)``; None
    when no axis has that size. N must divide by the client ranks
    (`ValueError`), never replicated silently."""
    for d in range(x.dim()):
        if x.shape[d] == num_clients:
            return (slice(None),) * d + (mesh.client_slice(num_clients),)
    return None


def shard_grid_inputs(states, data, num_clients: int, mesh):
    """This rank's rows of the states (a `DracoState` or a list of them,
    solo or seed-stacked; `protocol.shard_state`) and of the federated
    data shards (each tensor's first N-sized axis, `_client_sharding`).
    Returns ``(states, data)``; either may be None."""
    rows = mesh.client_slice(num_clients)
    if isinstance(states, (list, tuple)):
        states = [shard_state(s, rows) for s in states]
    elif states is not None:
        states = shard_state(states, rows)
    if data is not None:
        idx = [_client_sharding(x, num_clients, mesh) for x in data]
        data = tuple(x if i is None else x[i].contiguous() for x, i in zip(data, idx))
    return states, data


def simulate_sweep(
    algo: Union[str, Algorithm],
    cfg_grid,
    params0=None,
    loss_fn: Optional[Callable] = None,
    data: Any = None,
    num_steps: int = 1,
    *,
    task=None,
    task_key=None,
    keys=None,
    key=None,
    num_seeds: int = 1,
    eval_every: int = 0,
    eval_fn: Optional[Callable] = None,
    eval_data: Any = None,
    ctx: Optional[SimContext] = None,
    graph_seed: Optional[int] = None,
    schedules=None,
    final_fn: Optional[Callable] = None,
    states: Optional[Sequence] = None,
    device=None,
    draws_fn: Optional[Callable] = None,
    mesh=None,
):
    """Run a (config x scenario) x seed grid; returns ``(finals, SweepTrace)``.

    The reference's arguments, with the port's spellings:
      algo: registry name or `Algorithm` (one method per sweep).
      cfg_grid: one config, or a sequence differing only in the
        `SWEEPABLE` fields the algorithm declares (`algo.sweepable`).
      params0 / loss_fn / data / num_steps / task / task_key: as in
        `simulate`. Sweeping `lr` rebuilds the task's optimizer per row
        (the task must declare it in `task.sweepable`).
      keys: R int seeds (or generators), one per seed row; or `key` +
        `num_seeds`, split by `seed_keys`. Row r is the solo
        ``simulate(..., key=keys[r])``.
      states: instead of keys, R initial solo states (say, converted from
        the reference's); every grid row starts from copies of them.
      eval_every / eval_fn / eval_data: the metric cadence of `simulate`.
      ctx: a prebuilt base `SimContext` whose cfg equals the grid's base
        config (an event algorithm's carries its tape).
      graph_seed: seeds random topologies when building the context.
      schedules: optional same-shape `Schedule`s, one per grid row (the
        scenario axis); its length must match `cfg_grid` when both vary.
      final_fn: a reducer of each row's seed-stacked final state (say
        ``lambda s: s.total_accept``), so that a grid of rings is not
        kept.
      device: None means CUDA (raises without it); "cpu" on purpose.
      draws_fn: for tests, ``draws_fn(g, r, i)`` injects the draws of grid
        row g, seed r, step i (the algorithm's step index).
      mesh: a client mesh (`repro_torch.launch.mesh.Mesh`) to run ``draco``
        on, every rank of its world calling with the same arguments: each
        rank holds N / ranks clients (see the module docstring); the
        finals come back N-wide. Another algorithm raises
        `NotImplementedError` (ROADMAP item 21).

    `finals` is `final_fn`'s output (or the final states) with leading
    (G, R) axes: tensors stacked, host numbers as numpy arrays (a
    seed-stacked row's shared ``window_idx`` as (G,)), the generators as
    nested tuples. The trace metrics are (G, R, num_evals).
    """
    from repro_torch.tasks import is_task

    dev = resolve_device(device)
    if isinstance(algo, str):
        algo = get_algorithm(algo)
    if mesh is not None and type(algo) is not Draco:
        raise NotImplementedError(
            f"simulate_sweep(mesh=) runs draco only; {algo.name!r} on a client mesh is "
            f"{ROADMAP_MESH_BASELINES}")
    cfgs = list(cfg_grid) if isinstance(cfg_grid, (list, tuple)) else [cfg_grid]
    base, overrides = stack_configs(cfgs)
    task, workload, params0, data, eval_data = resolve_workload(
        base, task, task_key, loss_fn, params0, data, eval_data,
        need_params=states is None or ctx is None, need_data=ctx is None, device=dev)
    swept = [f for f in SWEEPABLE if getattr(overrides, f) is not None]
    if len(cfgs) > 1 and not swept:
        raise ValueError(
            f"cfg_grid has {len(cfgs)} entries but no field varies — the "
            "sweep would run identical rows; pass one config (seeds/"
            "schedules are separate axes)")
    unsupported = sorted(set(swept) - set(getattr(algo, "sweepable", ())))
    if unsupported:
        raise ValueError(
            f"{algo.name!r} does not consume override field(s) "
            f"{unsupported} (sweepable: {getattr(algo, 'sweepable', ())}); "
            "sweeping them would return identical rows")

    scheds = None
    if schedules is not None:
        scheds = stack_schedules(schedules)
    grid = max(len(cfgs), len(scheds) if scheds is not None else 1)
    if len(cfgs) not in (1, grid) or (scheds is not None and len(scheds) != grid):
        raise ValueError(
            f"grid axes disagree: {len(cfgs)} config(s) vs "
            f"{len(scheds)} schedule(s); a grid axis must cover "
            "every grid row (use a ctx-carried schedule for a constant "
            "scenario)")

    if states is not None:
        states = list(states)
    elif keys is None:
        if key is None:
            raise ValueError("pass keys=(R, ...) or key= + num_seeds=")
        keys = seed_keys(key, num_seeds)
    num_rows = len(states) if states is not None else len(keys)

    if ctx is None:
        data = tuple(t.to(dev) for t in data)
        ctx = make_context(base, workload, data, params0=params0, graph_seed=graph_seed,
                           device=dev)
    elif ctx.cfg != base:
        raise ValueError(
            "ctx.cfg differs from the grid's base config; pass "
            "ctx._replace(cfg=cfg_grid[0]) to reuse a context")
    elif workload is not None and ctx.task != workload:
        raise ValueError(
            "ctx.task differs from the task/loss_fn argument; pass "
            "ctx._replace(task=...) to rebind the workload")
    if ctx.overrides is not None:
        raise ValueError("ctx already carries overrides; sweeps own them")
    if scheds is not None and ctx.schedule is not None:
        raise ValueError("pass either schedules= or a ctx with a schedule, not both")
    if is_task(ctx.task) and "lr" in swept and "lr" not in ctx.task.sweepable:
        # a custom task whose make_optimizer ignores its lr argument must
        # say so: its grid rows would be silently identical
        raise ValueError(
            f"task {ctx.task.name!r} does not declare 'lr' sweepable "
            f"(task.sweepable={ctx.task.sweepable}): its make_optimizer "
            "does not consume the per-row lr override, so the grid rows "
            "would be identical")
    metric_name = "accuracy"
    if eval_fn is None and is_task(ctx.task) and eval_data is not None:
        eval_fn = ctx.task.eval_fn
    if is_task(ctx.task) and eval_fn is ctx.task.eval_fn:
        metric_name = ctx.task.metric_name
    if eval_fn is not None and eval_data is None:
        raise ValueError("eval_fn requires eval_data=(ex, ey)")
    if eval_data is not None:
        eval_data = tuple(t.to(dev) for t in eval_data)

    run = dict(eval_data=eval_data, num_steps=int(num_steps), eval_every=int(eval_every),
               eval_fn=eval_fn, metric_name=metric_name)
    if mesh is not None:
        _, data_loc = shard_grid_inputs(None, ctx.data, base.num_clients, mesh)
        ctx = ctx._replace(data=data_loc)
        algo = _MeshDraco(mesh)
    finals, traces = [], []
    for g in range(grid):
        ctx_g = ctx._replace(overrides=row_overrides(overrides, g if len(cfgs) > 1 else 0))
        if scheds is not None:
            ctx_g = ctx_g._replace(schedule=scheds[g])
        solo = ([_copy(s) for s in states] if states is not None else
                [algo.init(k, base, params0, task=ctx.task, device=dev) for k in keys])
        if mesh is not None:
            solo, _ = shard_grid_inputs(solo, None, base.num_clients, mesh)
        if getattr(algo, "seed_axis", False):
            fn = None if draws_fn is None else (
                lambda i, g=g: stack_draws([draws_fn(g, r, i) for r in range(num_rows)]))
            final, trace = _run(algo, ctx_g, stack_seeds(solo), draws_fn=fn,
                                seeds=num_rows, **run)
            if mesh is not None:
                final = gather_state(final, mesh)
        else:
            outs = [_run(algo, ctx_g, st, draws_fn=None if draws_fn is None else (
                lambda i, g=g, r=r: draws_fn(g, r, i)), **run) for r, st in enumerate(solo)]
            final = _stack([o[0] for o in outs])
            trace = SimTrace(outs[0][1].step, {k: np.stack([o[1].metrics[k] for o in outs])
                                                for k in outs[0][1].metrics})
        finals.append(final if final_fn is None else final_fn(final))
        traces.append(trace)
    if not traces[0].metrics:
        return _stack(finals), SweepTrace(np.zeros((0,), np.int32), {})
    metrics = {k: np.stack([t.metrics[k] for t in traces]) for k in traces[0].metrics}
    return _stack(finals), SweepTrace(traces[0].step, metrics)

"""Dry run: reckon one rank's share of every (arch x shape x mesh) pair
on ``meta`` tensors, and optionally run it on the card (port of
`repro.launch.dryrun`).

For train shapes the step is the DRACO window step
(`steps.make_train_step`: local grads, the gossip mix, apply); decode
shapes take `steps.make_serve_step` (one token against a KV/SSM cache),
prefill shapes `steps.make_prefill_step` (the full-prompt forward). Each
is built at full width and full depth and run once on
``torch.device("meta")`` under the counters of
`repro_torch.launch.roofline.count_work`, with a `Mesh` built without a
world (`Mesh.dry`): same class and step code, result shapes on
``meta``, its collective tally filled, nothing sent. A row of
`Roofline.row()` plus the reference's extra keys is appended to
``results/dryrun.jsonl``.

Layout. The reference's production mesh, (16, 16) over ("data",
"model"), shards each model over a 16-way "model" axis, which the port
does not have (ROADMAP item 20): the default mesh raises
`NotImplementedError` here, as `launch/mesh.py::Mesh` does. ``--clients
W`` takes the client mesh (W, 1) of `make_sweep_mesh` instead (W ranks,
one client each; written ``"Wx1"`` in the row's ``mesh``), the layout the
reference also has (``repro.launch.mesh``'s sweep mesh).

What the row holds:
  - ``flops_per_device`` / ``bytes_per_device``: the rank's share,
    counted at full depth (every layer is seen, so there is nothing to
    correct: ``cost_correction.method`` is ``"counted"``), each kernel as
    one op with its bound's work (``kernel_work``);
  - ``coll_bytes_per_device`` / ``coll_breakdown``: the dry mesh's tally
    of result bytes per collective kind, its calls under ``"counts"``;
  - ``memory_analysis``: ``argument_size_in_bytes`` and
    ``output_size_in_bytes`` exact from the meta tensors,
    ``temp_size_in_bytes`` the peak live bytes of the tensors the step
    makes (a dispatch mode with a weakref finalizer on each storage:
    exact on ``meta``, where storages die when their last tensor does,
    as the caching allocator frees them on the card;
    `torch.distributed._tools.mem_tracker` would need `FakeTensorMode`,
    whose tensors claim the card's device, so the kernel wrappers would
    try to launch instead of reporting their work), and
    ``generated_code_size_in_bytes`` null; ``reckoned_peak_bytes`` is
    arguments plus temporaries;
  - ``necessary_bytes``, the arguments read once and the outputs written
    once, and ``t_bound_s``, the larger of ``model_flops`` over the
    ranks at the card's peak and ``necessary_bytes`` over its memory
    rate: the least time of the rank's share whatever implements it (the
    eager bytes of ``t_memory_s`` shrink when ops are fused; these do
    not).
  - ``t_lower_s`` the time to build the step and its inputs,
    ``t_compile_s`` the counted run's.

``--run`` then runs the same share on one card (the dry mesh on CUDA:
its collectives are the rank's local share, so the collective's time
stays the roofline's and the row says ``collective_measured: false``):
steady seconds per step by CUDA events after a warm-up step, the host
syncs the CUDA sync detector saw in the timed loop (``host_syncs``), the
peak of ``torch.cuda.max_memory_allocated`` while the steps run, above
what was allocated before the inputs, and ``roofline_fraction =
max(t_compute, t_memory) / measured`` (how far the eager step is
from its own traffic) and ``bound_fraction = t_bound_s / measured``
(how far it is from the work itself). At full depth when the reckoned
peak fits the card with headroom (`FIT_SHARE`); otherwise at depths 1
and 2 (`steps.depth_config`), extrapolated ``c1 + (G - 1) (c2 - c1)``
(``run_depth: [1, 2]``; ``--no-correct``: not extrapolated, the depth-2
numbers as they are).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k --clients 16
  python -m repro_torch.launch.dryrun --all --clients 16
  python -m repro_torch.launch.dryrun --arch mamba2-2.7b --shape long_500k --clients 1 --run
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
import traceback
import warnings
from typing import Optional

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.roofline import (Roofline, collective_bytes, count_work,
                                         model_flops_analytic, tensors_of)
from repro_torch.models import model as M

FIT_SHARE = 0.85  # a full-depth --run needs its reckoned peak under this share of the card
RUN_STEPS = 3
RUN_SEED = 0  # the random weights and inputs of a --run


def make_dry_mesh(clients: Optional[int], multi_pod: bool = False, device="meta"):
    """(world-less `Mesh` standing for client rank 0, its name): the
    reference's production mesh when `clients` is None (which raises,
    ROADMAP item 20), else the client mesh (W, 1), with "pod" (2, W, 1)."""
    if clients is None:
        shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
            else ((16, 16), ("data", "model"))
    else:
        shape, axes = ((2, clients, 1), ("pod", "data", "model")) if multi_pod \
            else ((clients, 1), ("data", "model"))
    mesh = mesh_lib.Mesh.dry(shape, axes, device=device)
    return mesh, "x".join(str(s) for s in shape)


def _meta_like(t: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device="meta")


def _rows(mesh, n: int, what: str) -> int:
    if n % mesh.size:
        raise NotImplementedError(
            f"{what} of {n} does not divide over the mesh's {mesh.size} client ranks; "
            f"sharding another axis instead is {steps_lib.ROADMAP_CACHE_SEQ}")
    return n // mesh.size


def _inputs(cfg, shape, mesh, device):
    """The rank's share of the step's inputs: meta tensors on ``meta``,
    random ones from `RUN_SEED` on a real device."""
    from repro_torch.launch import train as train_lib

    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(RUN_SEED)
    if shape.mode == "train":
        n = mesh_lib.num_clients(mesh)
        n_loc = _rows(mesh, n, "the client count")
        b = shape.global_batch // n  # train_batch_specs raises when it does not divide
        specs = steps_lib.train_batch_specs(cfg, shape, n)
        if meta:
            params = steps_lib.stack_clients_abstract(steps_lib.param_specs_abstract(cfg),
                                                      n_loc)
            batch = {k: _meta_like(v, n_loc) for k, v in specs.items()}
            q = torch.empty((n, n), dtype=torch.float32, device="meta")
        else:
            params = train_lib.init_client_params(RUN_SEED, cfg, n_loc, device)
            batch = train_lib.make_batches(gen, cfg, n_loc, b, shape.seq_len, device)
            q = torch.rand((n, n), generator=gen, device=device)
            q = q / q.sum(dim=1, keepdim=True)
        return params, batch, q
    scfg = steps_lib.serve_config(cfg, shape)
    rows = _rows(mesh, shape.global_batch, "the batch")
    params = steps_lib.param_specs_abstract(scfg) if meta else M.init_params(RUN_SEED, scfg,
                                                                             device)

    def embeds(*dims):
        if meta:
            return torch.empty(dims, dtype=cfg.torch_dtype, device="meta")
        return torch.randn(dims, generator=gen, device=device).to(cfg.torch_dtype)

    if shape.mode == "prefill":
        batch = {}
        if cfg.embeds_in:
            batch["embeds"] = embeds(rows, shape.seq_len, cfg.d_model)
        else:
            batch["tokens"] = (torch.empty((rows, shape.seq_len), dtype=torch.int64,
                                           device="meta") if meta else
                               torch.randint(0, cfg.vocab_size, (rows, shape.seq_len),
                                             generator=gen, device=device))
        if cfg.family == "vlm":
            batch["cross_embeds"] = embeds(rows, cfg.num_patch_tokens, cfg.d_model)
        return params, batch
    state = M.init_decode_state(scfg, rows, shape.seq_len, device=device)
    if cfg.embeds_in:
        tok = embeds(rows, 1, cfg.d_model)
    else:
        tok = (torch.empty((rows,), dtype=torch.int64, device="meta") if meta else
               torch.randint(0, cfg.vocab_size, (rows,), generator=gen, device=device))
    if cfg.family != "vlm":
        return params, tok, state
    with torch.no_grad():
        cross = M.init_cross_kv(params, scfg, embeds(rows, cfg.num_patch_tokens, cfg.d_model))
    return params, tok, state, cross


def build(cfg, shape, mesh, *, device="meta", mix_mode: str = "dense",
          psi: int = 0, mix_dtype=None, blocked_threshold: int = 8192,
          vocab_chunk: int = 0, seq_parallel: bool = False):
    """``(step, args)``: the pair's step for the rank of `mesh` and that
    rank's inputs on `device`."""
    if seq_parallel:
        raise NotImplementedError("seq_parallel lays the residual stream's 'seq' axis on "
                                  f"\"model\" ({mesh_lib.ROADMAP_MODEL_AXIS})")
    if shape.mode == "train":
        md = torch.bfloat16 if mix_dtype == "bf16" else None
        step = steps_lib.make_train_step(cfg, mesh, mix_mode=mix_mode, psi=psi, mix_dtype=md,
                                         blocked_threshold=blocked_threshold,
                                         vocab_chunk=vocab_chunk)
    elif shape.mode == "prefill":
        step = steps_lib.make_prefill_step(cfg, shape, mesh)
    else:
        step = steps_lib.make_serve_step(cfg, shape, mesh)
    return step, _inputs(cfg, shape, mesh, device)


def nbytes(tree) -> int:
    """Bytes of every tensor in `tree` (each tensor's own elements)."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def reckon(cfg, shape, mesh, **kw) -> dict:
    """The counted meta run of one pair: flops, bytes, kernel work, the
    collective tally and the memory analysis."""
    t0 = time.time()
    step, args = build(cfg, shape, mesh, **kw)
    t_lower = time.time() - t0
    t0 = time.time()
    w = count_work(step, *args)
    t_count = time.time() - t0
    coll = collective_bytes(mesh)
    counts = coll.pop("_counts")
    arg_bytes, out_bytes = nbytes(args), nbytes(w.result)
    return {
        "flops": w.flops, "bytes": w.bytes, "coll": float(sum(coll.values())),
        "coll_breakdown": coll, "coll_counts": counts, "kernels": w.kernels,
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": w.temp_peak,
                   "generated_code_size_in_bytes": None},
        "peak": arg_bytes + w.temp_peak, "t_lower": t_lower, "t_count": t_count,
    }


def _timed_steps(step, args, dev) -> dict:
    """`RUN_STEPS` steps between two CUDA events, under the CUDA sync detector:
    ``{"s_per_step", "host_syncs"}`` (the steps read nothing on the host,
    so the loop runs ahead of the card)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            start.record()
            for _ in range(RUN_STEPS):
                step(*args)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    return {"s_per_step": start.elapsed_time(end) / 1e3 / RUN_STEPS, "host_syncs": syncs}


def measure(cfg, shape, clients, *, multi_pod=False, **kw) -> dict:
    """One pair's share run on the card: ``{"s_per_step", "host_syncs",
    "peak_bytes"}`` over `RUN_STEPS` steps after one warm-up step;
    ``peak_bytes`` is the peak allocated while the steps ran, above what
    was allocated before the inputs were made (the inputs' own making,
    whose f32 draws are cast to the model's dtype, is not the step's)."""
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    base = torch.cuda.memory_allocated(dev)
    mesh, _ = make_dry_mesh(clients, multi_pod, device=dev)
    step, args = build(cfg, shape, mesh, device=dev, **kw)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step(*args)
    torch.cuda.synchronize(dev)
    out = _timed_steps(step, args, dev)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _extrapolate(c1: dict, c2: dict, n_groups: int) -> dict:
    out = {k: c1[k] + (n_groups - 1) * (c2[k] - c1[k]) for k in ("s_per_step", "peak_bytes")}
    out["host_syncs"] = max(c1["host_syncs"], c2["host_syncs"])
    return out


def lower_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
               mix_mode: str = "dense", psi: int = 0, verbose: bool = True,
               cost_correct: bool = True, mix_dtype=None,
               blocked_threshold: int = 8192, cache_shard: str = "kv_heads",
               vocab_chunk: int = 0, seq_parallel: bool = False,
               clients: Optional[int] = None, run: bool = False, cfg=None):
    """Reckon (and with `run`, measure) one pair; returns its row.
    `cfg` replaces ``get_config(arch)`` (a reduced config in tests);
    `cache_shard` is recorded: the client mesh has no "model" axis to
    shard a cache over."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh, mesh_name = make_dry_mesh(clients, multi_pod)
    _, n_groups = M.block_pattern(cfg)
    kw = dict(mix_mode=mix_mode, psi=psi, mix_dtype=mix_dtype,
              blocked_threshold=blocked_threshold, vocab_chunk=vocab_chunk,
              seq_parallel=seq_parallel)
    art = reckon(cfg, shape, mesh, **kw)
    corr_meta = {"method": "counted"}
    roof = Roofline(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        mode=shape.mode,
        flops_per_device=art["flops"],
        bytes_per_device=art["bytes"],
        coll_bytes_per_device=art["coll"],
        coll_breakdown={**art["coll_breakdown"], "counts": art["coll_counts"]},
        model_flops=model_flops_analytic(cfg, shape),
        peak_memory_bytes=float(art["memory"]["temp_size_in_bytes"]),
        n_devices=math.prod(mesh.shape.values()),
        kernel_work=art["kernels"],
    )
    necessary = art["memory"]["argument_size_in_bytes"] + art["memory"]["output_size_in_bytes"]
    t_bound = max(roof.model_flops / roof.n_devices / roof.peaks.flops,
                  necessary / roof.peaks.hbm_bw)
    row = roof.row()
    row.update({
        "mix_mode": mix_mode,
        "psi": psi,
        "mix_dtype": mix_dtype or "f32",
        "blocked_threshold": blocked_threshold,
        "cache_shard": cache_shard,
        "vocab_chunk": vocab_chunk,
        "seq_parallel": seq_parallel,
        "t_lower_s": art["t_lower"],
        "t_compile_s": art["t_count"],
        "memory_analysis": art["memory"],
        "cost_correction": corr_meta,
        "clients": clients,
        "kernel_work": art["kernels"],
        "reckoned_peak_bytes": art["peak"],
        "necessary_bytes": necessary,
        "t_bound_s": t_bound,
    })
    if run:
        measured, corr_meta["measured"] = run_pair(
            cfg, shape, clients, roof, art, n_groups, multi_pod=multi_pod,
            cost_correct=cost_correct, **kw)
        row.update(measured)
        row["bound_fraction"] = t_bound / row["measured_s_per_step"]
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_name} (mode={shape.mode}, mix={mix_mode}) ==")
        print(f"  build {art['t_lower']:.1f}s count {art['t_count']:.1f}s  "
              f"[{corr_meta['method']}]")
        print(f"  memory_analysis: {art['memory']}")
        print(f"  cost (counted): flops/dev={row['flops_per_device']:.3e} "
              f"bytes/dev={row['bytes_per_device']:.3e} "
              f"coll/dev={row['coll_bytes_per_device']:.3e}")
        print(f"  collective schedule: {art['coll_counts']}")
        print(f"  kernels: {art['kernels']}")
        print(f"  roofline: compute={roof.t_compute*1e3:.2f}ms memory={roof.t_memory*1e3:.2f}ms "
              f"collective={roof.t_collective*1e3:.2f}ms -> {roof.bottleneck}-bound")
        print(f"  MODEL_FLOPS={roof.model_flops:.3e} useful_ratio={roof.useful_flops_ratio:.3f}")
        if run:
            print(f"  run ({row['run_depth']}): {row['measured_s_per_step']:.6f} s/step, peak "
                  f"{row['measured_peak_bytes'] / 2**30:.3f} GiB (reckoned "
                  f"{row['reckoned_run_peak_bytes'] / 2**30:.3f}), roofline_fraction "
                  f"{row['roofline_fraction']:.4f}, bound_fraction "
                  f"{row['bound_fraction']:.4f}")
    return row


def run_pair(cfg, shape, clients, roof, art, n_groups, *, multi_pod, cost_correct, **kw):
    """`lower_pair`'s ``--run``: (the measured keys of the row, how they
    were measured)."""
    if not torch.cuda.is_available():
        raise RuntimeError("--run measures on a CUDA card and none is available")
    total = torch.cuda.get_device_properties(0).total_memory
    if art["peak"] <= FIT_SHARE * total or n_groups < 2:
        got = measure(cfg, shape, clients, multi_pod=multi_pod, **kw)
        depth, method, reckoned = "full", {"method": "full-depth"}, art["peak"]
    else:
        cs, peaks = [], []
        for k in (1, 2):
            ck = steps_lib.depth_config(cfg, k)
            mesh_k, _ = make_dry_mesh(clients, multi_pod)
            peaks.append(reckon(ck, shape, mesh_k, **kw)["peak"])
            cs.append(measure(ck, shape, clients, multi_pod=multi_pod, **kw))
        got = _extrapolate(cs[0], cs[1], n_groups) if cost_correct else dict(cs[1])
        reckoned = peaks[0] + (n_groups - 1) * (peaks[1] - peaks[0]) if cost_correct \
            else peaks[1]
        depth = [1, 2]
        method = {"method": "depth-extrapolation" if cost_correct else "depth-2",
                  "depth1": cs[0], "depth2": cs[1], "reckoned_peaks": peaks}
    return {
        "run_depth": depth,
        "measured_s_per_step": got["s_per_step"],
        "measured_peak_bytes": got["peak_bytes"],
        "host_syncs": got["host_syncs"],
        "reckoned_run_peak_bytes": reckoned,
        "roofline_fraction": max(roof.t_compute, roof.t_memory) / got["s_per_step"],
        "collective_measured": False,
        "device_kind": torch.cuda.get_device_name(0),
    }, method


def shape_order():
    """Cheap modes first, as the reference (partial progress covers more pairs)."""
    return sorted(SHAPES, key=lambda s: {"decode": 0, "prefill": 1, "train": 2}[SHAPES[s].mode])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mix", default="dense", choices=["dense", "ring", "none"])
    ap.add_argument("--psi", type=int, default=0)
    ap.add_argument("--no-correct", action="store_true")
    ap.add_argument("--mix-dtype", default=None, choices=[None, "bf16"])
    ap.add_argument("--train-attn-blocked", action="store_true",
                    help="use blocked online-softmax attention in train_4k")
    ap.add_argument("--cache-shard", default="kv_heads",
                    choices=["kv_heads", "head_dim", "seq"])
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--clients", type=int, default=None,
                    help="the client mesh (W, 1): W ranks of one client each (default: "
                         "the reference's (16, 16) production mesh, which raises)")
    ap.add_argument("--run", action="store_true",
                    help="also run the rank's share on the card and record its time")
    args = ap.parse_args(argv)

    common = dict(mix_mode=args.mix, psi=args.psi, cost_correct=not args.no_correct,
                  clients=args.clients, run=args.run)
    if args.all:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        failures = []
        for shape in shape_order():
            for arch in ARCH_IDS:
                for mp in ([False, True] if args.both_meshes else [args.multi_pod]):
                    try:
                        row = lower_pair(arch, shape, multi_pod=mp, **common)
                        with open(args.out, "a") as f:
                            f.write(json.dumps(row) + "\n")
                    except Exception as e:
                        traceback.print_exc()
                        failures.append((arch, shape, mp, f"{type(e).__name__}: {e}"))
                    gc.collect()
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("ALL PAIRS RECKONED OK")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    row = lower_pair(args.arch, args.shape, multi_pod=args.multi_pod,
                     mix_dtype=args.mix_dtype,
                     blocked_threshold=1024 if args.train_attn_blocked else 8192,
                     cache_shard=args.cache_shard, vocab_chunk=args.ce_chunk,
                     seq_parallel=args.seq_parallel, **common)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()

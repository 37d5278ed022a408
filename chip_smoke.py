#!/usr/bin/env python3
"""Drive the PyTorch port of DRACO (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   - compile every CUDA source of the port with nvcc (sm_90a);
  2. kernels - each kernel's wrapper against its plain PyTorch version on
               the card, at the main path's shapes and the edge cases;
  3. main    - `simulate("draco", ...)` at the paper's EMNIST scale
               (25 clients, MLP 784-160-100-47, Psi = 6, wireless channel)
               for 300 windows: launches per window, accuracy, finiteness,
               no host sync inside the window loop;
  4. plain   - 50 windows of the main path twice from one seed, through
               the kernel and through the plain drain: final params agree;
  5. times   - each kernel's time (CUDA events) beside its bound, its plain
               version and one PyTorch library call computing the same.

The line before the last is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Exits non-zero without CUDA and
without the repository's `src/` beside this file.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
RTOL = ATOL = 1e-5  # kernel against its plain version: f32 sums reordered
PATH_TOL = 1e-4  # 50 windows, kernel path against the plain-drain path
WINDOWS, EVAL_EVERY, PLAIN_WINDOWS = 300, 100, 50
SPIN_CYCLES = 2_000_000  # about 1 ms of device clock, to cover host enqueue
SEED = 0


def log(msg):
    print(msg, flush=True)


def emnist_config():
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.tasks import get_task

    # the reference's examples/quickstart.py at configs/draco_paper.py:EMNIST
    cfg = DracoConfig(
        num_clients=25, lr=0.05, local_batches=1, batch_size=64,
        lambda_grad=0.3, lambda_tx=0.3, unify_period=50, psi=6,
        topology="cycle", max_delay_windows=4,
        channel=ChannelConfig(message_bytes=596_776, gamma_max=10.0))
    task = get_task("mlp", input_dim=784, hidden=(160, 100), num_classes=47,
                    per_client=1000)
    return cfg, task


def drain_case(torch, j, n, m, k, s, nonempty, dtype, seed):
    """w_stack (J, N, M), ring (S, N, K), slots: a row-stochastic Q split
    over J delay buckets, the first `nonempty` buckets live."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.rand((n, m), generator=g, device="cuda")
    q = q / q.sum(dim=1, keepdim=True)
    bucket = torch.randint(0, max(nonempty, 1), (n, m), generator=g, device="cuda")
    w = torch.stack([q * (bucket == b) * (b < nonempty) for b in range(j)])
    ring = torch.randn((s, n, k), generator=g, device="cuda").to(dtype)
    slots = [(s - 1 - a) % s for a in range(j, 0, -1)]  # widx = s-1, oldest first
    return w.float().contiguous(), ring, slots


def bound_ms(j_live, j, n, m, k, elem_bytes):
    """Least time for one drain: each input byte read once, the output
    written once, over the memory rate; f32 FMAs over the f32 rate."""
    moved = j_live * n * k * elem_bytes + j * n * m * 4 + m * k * 4
    flops = 2 * j_live * n * m * k
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps=60, flush=None):
    """Median over `reps` launches of CUDA-event time, L2 flushed before each.

    A spin kernel ahead of the start event keeps the card busy while the
    host enqueues the start event, the call and the end event, so the
    interval holds device time only and no host launch gap. (A call that
    reads the device itself, as the plain drain does, still waits.)"""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels.gossip import build

    t0 = time.perf_counter()
    paths = build.build()
    log(f"phase 1 build: {len(paths)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        report = path.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return paths


def phase_kernels(torch):
    from repro_torch.kernels.gossip import ops

    cases = []
    for live in (0, 1, 3):  # main-path shapes; most Psi-capped buckets are empty
        cases.append((f"main J=3 N=M=25 K=146447 f32 live={live}",
                      dict(j=3, n=25, m=25, k=146_447, s=4, nonempty=live,
                           dtype=torch.float32)))
    cases.append(("main J=3 N=M=25 K=146447 bf16 live=3",
                  dict(j=3, n=25, m=25, k=146_447, s=4, nonempty=3,
                       dtype=torch.bfloat16)))
    for depth in (2, 4, 8):
        cases.append((f"N=7 K=1000 D={depth}",
                      dict(j=depth - 1, n=7, m=7, k=1000, s=depth,
                           nonempty=depth - 1, dtype=torch.float32)))
    cases.append(("rectangular J=3 N=8 M=16 K=5000",
                  dict(j=3, n=8, m=16, k=5000, s=4, nonempty=3, dtype=torch.float32)))
    cases.append(("N=M=64 K=2049", dict(j=3, n=64, m=64, k=2049, s=4, nonempty=2,
                                        dtype=torch.float32)))
    worst = 0.0
    for i, (label, kw) in enumerate(cases):
        w, ring, slots = drain_case(torch, seed=i, **kw)
        got = ops.gossip_drain(w, ring, slots)
        ref = ops.gossip_drain_reference(w, ring, slots)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
        worst = max(worst, err)
        log(f"  drain {label}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"drain kernel disagrees with its plain version: {label}")
    log(f"phase 2 kernels: gossip_drain max_abs_err={worst:.3e} "
        f"(tolerance rtol={RTOL} atol={ATOL}) over {len(cases)} cases")
    return worst


def phase_main(torch):
    from repro_torch.api import make_context, simulate
    from repro_torch.core import protocol
    from repro_torch.kernels.gossip import ops

    cfg, task = emnist_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params0 = task.init_params(gen)
    data, eval_data = task.make_data(gen, cfg.num_clients)
    ctx = make_context(cfg, task=task, data=data, params0=params0)
    torch.cuda.synchronize()

    ops.gossip_drain.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, trace = simulate("draco", cfg, params0, data=data, num_steps=WINDOWS,
                            task=task, key=SEED + 1, eval_every=EVAL_EVERY,
                            eval_data=eval_data, ctx=ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.gossip_drain.launches
    for step, acc, cons in zip(trace.step, trace.metrics["accuracy"],
                               trace.metrics["consensus"]):
        log(f"  window {int(step):4d}: mean client acc {float(acc):.4f}, "
            f"consensus distance {float(cons):.6f}")
    accepted = int(state.total_accept.sum())
    log(f"  msgs accepted total {accepted}; drain launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"  {WINDOWS} windows + {len(trace.step)} evals in {wall:.3f} s: "
        f"{wall / WINDOWS * 1e3:.3f} ms/window")
    if launches != WINDOWS:
        raise AssertionError(f"drain launched {launches} times in {WINDOWS} windows")
    finite = all(np.isfinite(v).all() for v in trace.metrics.values()) and all(
        bool(torch.isfinite(p).all()) for p in state.params.values())
    if not finite:
        raise AssertionError("non-finite metrics or params")
    if float(trace.metrics["accuracy"][-1]) < 0.5:
        raise AssertionError(f"final accuracy {trace.metrics['accuracy'][-1]} < 0.5")

    # steady state, no host sync: a fresh run under the sync detector
    st = protocol.init_state(SEED + 2, cfg, params0)
    st = protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data, 5)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            st = protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data, 100)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / 100 * 1e3
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    log(f"  steady state: {steady:.3f} ms/window over 100 windows; "
        f"host syncs in the loop: {len(syncs)}")
    if syncs:
        raise AssertionError(f"host sync inside the window loop: {syncs[0]}")
    profile_windows(torch, protocol, st, cfg, ctx, task, data, steady)
    log(f"phase 3 main: final accuracy {float(trace.metrics['accuracy'][-1]):.4f}")
    return launches, wall / WINDOWS * 1e3, steady, ctx, params0, data


def profile_windows(torch, protocol, st, cfg, ctx, task, data, steady_ms):
    """Device time by kernel over 20 profiled windows, and the device's
    busy share of an unprofiled steady window (`steady_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data, 20)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue  # CPU ops also carry their kernels' time
            dev = getattr(evt, "self_device_time_total", None)
            if dev is None:
                dev = getattr(evt, "self_cuda_time_total", 0.0)
            if dev > 0:
                rows.append((dev, evt.key, evt.count))
    except (RuntimeError, AttributeError) as exc:
        log(f"  profiler: not measured ({exc})")
        return
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("  profiler: no device time recorded (not measured)")
        return
    per_window_us = busy / 20
    share = per_window_us / (steady_ms * 1e3)
    log(f"  profiler over 20 windows: device busy {per_window_us:.1f} us/window "
        f"({wall_us / 20:.1f} us/window wall under the profiler); against the "
        f"unprofiled steady window: {100 * share:.2f}% busy, "
        f"{100 - 100 * share:.2f}% idle")
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        log(f"    {dev / 20:9.2f} us/window  {count:5d}x  {key[:90]}")


def phase_plain(torch, ctx, params0, data):
    from repro_torch.core import protocol
    from repro_torch.kernels.gossip import ops

    cfg, task = ctx.cfg, ctx.task
    runs = {}
    for name, drain in (("kernel", None), ("plain", ops.gossip_drain_reference)):
        st = protocol.init_state(SEED + 3, cfg, params0)
        runs[name] = protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data,
                                          PLAIN_WINDOWS, drain=drain)
    torch.cuda.synchronize()
    worst = 0.0
    for k in runs["kernel"].params:
        a, b = runs["kernel"].params[k], runs["plain"].params[k]
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=PATH_TOL, atol=PATH_TOL):
            raise AssertionError(f"kernel path and plain path differ in {k}")
    same_accept = torch.equal(runs["kernel"].total_accept, runs["plain"].total_accept)
    log(f"phase 4 plain: {PLAIN_WINDOWS} windows, kernel vs plain drain "
        f"max |dparams| = {worst:.3e} (tolerance {PATH_TOL}); same acceptances "
        f"{same_accept}")
    if not same_accept:
        raise AssertionError("kernel path and plain path accepted different messages")


def phase_times(torch):
    from repro_torch.kernels.gossip import ops

    j, n, m, k, s = 3, 25, 25, 146_447, 4
    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # > the 50 MB L2
    out = {}
    for live in (1, 3):
        w, ring, slots = drain_case(torch, j, n, m, k, s, live, torch.float32, 100 + live)
        slots_dev = torch.tensor(slots, device="cuda")
        kern = time_ms(torch, lambda: ops.gossip_drain(w, ring, slots), flush=flush)
        plain = time_ms(torch, lambda: ops.gossip_drain_reference(w, ring, slots),
                        flush=flush)
        lib = time_ms(torch, lambda: torch.einsum("jnm,jnk->mk", w, ring[slots_dev]),
                      flush=flush)
        bound, by = bound_ms(live, j, n, m, k, 4)
        out[live] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by)
        log(f"  drain J=3 N=M=25 K=146447 f32, {live} live bucket(s): kernel "
            f"{kern:.4f} ms, bound {bound:.4f} ms ({by}, {100 * bound / kern:.1f}% of "
            f"bound), plain {plain:.4f} ms, library einsum {lib:.4f} ms")
    log("phase 5 times: done")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (TF32 off)

    phase_build()
    max_err = phase_kernels(torch)
    launches, ms_window, steady, ctx, params0, data = phase_main(torch)
    phase_plain(torch, ctx, params0, data)
    times = phase_times(torch)
    kernels = [dict(
        name="gossip_drain", route="cuda",
        source="src/repro_torch/kernels/gossip/csrc/drain.cu",
        replaces="src/repro/kernels/gossip/gossip.py:100",
        launches=launches, max_abs_err=max_err, **times[3])]
    log(f"main path: {ms_window:.3f} ms/window (300-window simulate, evals "
        f"included), {steady:.3f} ms/window steady")
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark harness of the port: one function per bench of
`benchmarks/run.py`, on `repro_torch` (which imports no JAX).

Protocol-level benches run through `repro_torch.api` (`simulate`,
`simulate_sweep` and the algorithm registry); `draco_window` times the
fused engine (one drain-kernel launch per window) against the legacy
per-bucket engine; `gossip` and `ssd` time the hand-written kernels
against their plain versions, each row named by what ran (``kernel`` on
the card, ``plain`` on the CPU, where the wrappers take the plain
version). `decode` waits for the port's serving path.

Prints ``name,us_per_call,derived`` CSV and mirrors the timings to
``BENCH_torch.json`` (name -> us_per_call). Every bench runs on CUDA
and raises without a card; ``--device cpu`` runs on the CPU on purpose.

  PYTHONPATH=src python -m benchmarks.torch_run            # full set
  PYTHONPATH=src python -m benchmarks.torch_run --quick    # CI-sized
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from benchmarks.torch_common import device_label, emit, time_fn
from repro_torch import resolve_device

DEFAULT_JSON = "BENCH_torch.json"
# ssd_forward against the sequential recurrence, relative to the largest |y|
SSD_REL_TOL = 1e-4


def _route(dev) -> str:
    """What a kernel wrapper runs on `dev`: the kernel on the card, its
    plain version on the CPU."""
    return "kernel" if dev.type == "cuda" else "plain"


def bench_gossip_mix(quick=False, device=None, out_dir="."):
    """Kernel layer: row-stochastic mixing at paper scale (25 clients,
    a 0.57 MB model = ~149k f32 params): `core.mixing.mix_dense` (ravel,
    one launch of the mix kernel, unravel), as the reference times it;
    in full also the mix alone on the raveled plane (`mix_plane`) beside
    the plain `gossip_mix_ref` on the same plane."""
    from repro_torch.core.mixing import mix_dense, mix_plane
    from repro_torch.kernels.gossip.ref import gossip_mix_ref

    dev = resolve_device(device)
    n, d = 25, 149_194
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.softmax(torch.randn((n, n), generator=g, device=dev), dim=-1)
    deltas = torch.randn((n, d), generator=g, device=dev)
    us = time_fn(lambda: mix_dense(q, {"w": deltas})["w"])
    emit(f"gossip_mix_{_route(dev)}_25x149k", us, f"{n * n * d * 2 / us * 1e6 / 1e9:.1f}GFLOPs")
    if not quick:
        us_k = time_fn(lambda: mix_plane(q, deltas))
        us_p = time_fn(lambda: gossip_mix_ref(q, deltas))
        emit(f"gossip_mix_plane_{_route(dev)}_25x149k", us_k,
             "one kernel launch" if dev.type == "cuda" else "the plain version")
        emit("gossip_mix_plain_ref_25x149k", us_p, f"plane_speedup={us_p / us_k:.2f}x")


def bench_ssd(quick=False, device=None, out_dir="."):
    """SSD forward through the intra-chunk kernel (`ssd_forward`) against
    the sequential recurrence (`ssd_reference`), the Mamba2 layer."""
    from repro_torch.kernels.ssd.ops import ssd_forward
    from repro_torch.models.ssm import ssd_reference

    dev = resolve_device(device)
    B, T, H, P, G, N = (1, 512, 8, 32, 1, 32) if quick else (2, 1024, 16, 64, 1, 64)
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(B, T, H, P)
    dt = torch.nn.functional.softplus(randn(B, T, H))
    A = -torch.exp(randn(H))
    B_, C_ = randn(B, T, G, N), randn(B, T, G, N)
    D = torch.ones((H,), device=dev)
    with torch.no_grad():
        y_c = ssd_forward(x, dt, A, B_, C_, D, chunk=128)
        y_s = ssd_reference(x, dt, A, B_, C_, D)
        err, scale = float((y_c - y_s).abs().max()), float(y_s.abs().max())
        if not bool(torch.isfinite(y_c).all()) or err > SSD_REL_TOL * scale:
            raise AssertionError(f"ssd_forward disagrees with ssd_reference at T {T}: "
                                 f"max |err| {err} vs largest |y| {scale}")
        us_c = time_fn(lambda: ssd_forward(x, dt, A, B_, C_, D, chunk=128), iters=5)
        us_s = time_fn(lambda: ssd_reference(x, dt, A, B_, C_, D), iters=5)
    emit(f"ssd_forward_{_route(dev)}_T{T}", us_c, f"speedup_vs_seq={us_s / us_c:.2f}x")
    emit(f"ssd_sequential_T{T}", us_s, "oracle")


def bench_draco_window(quick=False, device=None, out_dir="."):
    """Protocol layer: the fused window (one drain launch) against the
    legacy per-bucket engine, at the paper's scale (N = 25, the EMNIST
    MLP, the wireless channel, a deep D = 8 ring). Each timed call runs
    `windows` windows on, from where the last call left the state."""
    from benchmarks.torch_fig3_convergence import setup
    from repro_torch.core.protocol import (
        build_graph,
        init_state,
        init_state_legacy,
        run_windows,
        run_windows_legacy,
    )

    dev = resolve_device(device)
    n = 8 if quick else 25
    D = 4 if quick else 8
    windows = 6 if quick else 16
    iters = 3 if quick else 5
    cfg, train, test, params0, loss, acc, key = setup("emnist", num_clients=n, device=dev)
    cfg = cfg.replace(max_delay_windows=D)
    q, adj = build_graph(cfg, device=dev)
    st = {"fused": init_state(key, cfg, params0, device=dev),
          "legacy": init_state_legacy(key, cfg, params0, device=dev)}

    def fused():
        st["fused"] = run_windows(st["fused"], cfg, q, adj, loss, train, windows)

    def legacy():
        st["legacy"] = run_windows_legacy(st["legacy"], cfg, q, adj, loss, train, windows)

    with torch.no_grad():
        us_f = time_fn(fused, warmup=1, iters=iters) / windows
        us_l = time_fn(legacy, warmup=1, iters=iters) / windows
    emit(f"draco_window_fused_N{n}_D{D}", us_f, f"speedup_vs_seed_loop={us_l / us_f:.2f}x")
    emit(f"draco_window_legacy_N{n}_D{D}", us_l, "seed-path")


def bench_simulate_fused(quick=False, device=None, out_dir="."):
    """API layer: `simulate` (metrics sampled as device scalars, read once
    at the end) against the segment loop that reads the accuracy on the
    host after every `run_windows` segment. Same protocol and cadence."""
    from benchmarks.torch_fig3_convergence import setup
    from repro_torch.api import simulate
    from repro_torch.core.protocol import build_graph, init_state, run_windows

    dev = resolve_device(device)
    n = 8 if quick else 16
    windows = 60 if quick else 200
    every = 10 if quick else 25
    cfg, train, test, params0, loss, acc, key = setup("emnist", num_clients=n, device=dev)

    def fused():
        st, _ = simulate("draco", cfg, params0, loss, train, num_steps=windows, key=key,
                         eval_every=every, eval_fn=acc, eval_data=test, device=dev)
        return st.params

    q, adj = build_graph(cfg, device=dev)

    def segment_loop():
        st = init_state(key, cfg, params0, device=dev)
        with torch.no_grad():
            for _ in range(windows // every):
                st = run_windows(st, cfg, q, adj, loss, train, every)
                float(acc(st.params, test[0], test[1]).mean())
        return st.params

    us_f = time_fn(fused, warmup=1, iters=3)
    us_l = time_fn(segment_loop, warmup=1, iters=3)
    emit(f"simulate_fused_W{windows}_N{n}", us_f,
         f"speedup_vs_segment_loop={us_l / us_f:.2f}x")
    emit(f"segment_loop_W{windows}_N{n}", us_l, "legacy-path")


def _sweep_total_accept(state):
    return state.total_accept


def bench_sweep(quick=False, device=None, out_dir="."):
    """Sweep engine: an 8-seed x 6-config Psi grid at N = 25 run (a) as
    one `simulate_sweep` call (each row's 8 seeds in one seed-stacked
    state, one drain launch per window) and (b) as the per-cell loop of
    48 `simulate` calls it replaces. End to end (the first calls pay the
    kernels' loading and the allocator's growth) and steady. The task is
    small (~3k-param MLP), so the bench isolates the grid driver. Writes
    BENCH_torch_sweep.json."""
    from repro_torch.api import make_context, simulate, simulate_sweep
    from repro_torch.api.sweep import seed_keys
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.data.synthetic import federated_classification, make_mlp

    dev = resolve_device(device)
    n, seeds = 25, 8
    psis = (1, 2, 4, 8, 16, 24)
    windows = 8 if quick else 24
    every = 4 if quick else 8
    train, test = federated_classification(1, n, input_dim=16, num_classes=5,
                                           per_client=64, device=dev)
    params0, _, loss, acc = make_mlp(2, 16, (32,), 5, device=dev)
    cfg0 = DracoConfig(num_clients=n, lr=0.05, local_batches=1, batch_size=16,
                       lambda_grad=0.3, lambda_tx=0.3, unify_period=50,
                       topology="cycle", max_delay_windows=4,
                       channel=ChannelConfig(message_bytes=13_000, gamma_max=10.0))
    grid = [cfg0.replace(psi=int(p)) for p in psis]
    keys = seed_keys(0, seeds)
    ctx = make_context(grid[0], loss, train, params0=params0, device=dev)

    def sweep_once():
        _, trace = simulate_sweep(
            "draco", grid, params0, loss, train, windows, keys=keys, eval_every=every,
            eval_fn=acc, eval_data=test, ctx=ctx, final_fn=_sweep_total_accept,
            device=dev)
        return trace  # numpy: the device results are in

    def loop_once():
        out = []
        for cfg in grid:
            ctx_g = ctx._replace(cfg=cfg)
            for k in keys:
                _, tr = simulate("draco", cfg, params0, loss, train, windows, key=k,
                                 eval_every=every, eval_fn=acc, eval_data=test, ctx=ctx_g,
                                 device=dev)
                out.append(tr.metrics["accuracy"])
        return out

    t0 = time.perf_counter()
    sweep_once()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop_once()
    loop_s = time.perf_counter() - t0
    sweep_steady = time_fn(sweep_once, warmup=0, iters=2) / 1e6
    loop_steady = time_fn(loop_once, warmup=0, iters=2) / 1e6

    emit(f"sweep_grid_{seeds}x{len(psis)}_N{n}_W{windows}", sweep_s * 1e6,
         f"end2end_speedup_vs_loop={loop_s / sweep_s:.2f}x")
    emit(f"sweep_loop_{seeds}x{len(psis)}_N{n}_W{windows}", loop_s * 1e6,
         "python-loop-path")
    emit(f"sweep_grid_steady_{seeds}x{len(psis)}_N{n}", sweep_steady * 1e6,
         f"steady_speedup_vs_loop={loop_steady / sweep_steady:.2f}x")
    _write(out_dir, "BENCH_torch_sweep.json", {
        "grid": f"{seeds}seeds_x_{len(psis)}configs", "num_clients": n,
        "windows": windows, "eval_every": every, "sweep_s": sweep_s, "loop_s": loop_s,
        "speedup": loop_s / sweep_s, "sweep_steady_s": sweep_steady,
        "loop_steady_s": loop_steady, "steady_speedup": loop_steady / sweep_steady})


def bench_tasks(quick=False, device=None, out_dir="."):
    """Task layer: per-task DRACO window time at the paper scale (N = 25)
    through `simulate(task=...)`: the whole zoo plus mlp with AdamW (the
    (N, 2 * Dflat + 1) optimizer plane). Writes BENCH_torch_tasks.json."""
    from repro_torch.api import simulate
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.tasks import get_task, list_tasks

    dev = resolve_device(device)
    n = 8 if quick else 25
    windows = 6 if quick else 12
    iters = 2 if quick else 5
    cfg = DracoConfig(num_clients=n, lr=0.05, local_batches=1, batch_size=16,
                      lambda_grad=0.3, lambda_tx=0.3, unify_period=50,
                      topology="cycle", max_delay_windows=4)
    rows = {}
    for name, opt in [(name, "sgd") for name in list_tasks()] + [("mlp", "adamw")]:
        task = get_task(name, optimizer=opt)

        def one_run(task=task):
            st, _ = simulate("draco", cfg, task=task, num_steps=windows, key=0, device=dev)
            return st.window_idx

        us = time_fn(one_run, warmup=1, iters=iters) / windows
        tag = f"task_{name}" + (f"_{opt}" if opt != "sgd" else "")
        emit(f"{tag}_draco_window_N{n}", us, f"grad_cost={task.grad_cost:.3g}MFLOP")
        rows[f"{tag}_us_per_window"] = us
    rows.update({"num_clients": n, "windows": windows})
    _write(out_dir, "BENCH_torch_tasks.json", rows)


def bench_fig3(quick=False, device=None, out_dir="."):
    """Fig. 3 (both panels): DRACO against the baselines, final accuracy."""
    from benchmarks.torch_fig3_convergence import run

    for task in (("emnist",) if quick else ("emnist", "poker")):
        curves = run(task, segments=3 if quick else 6, seg_windows=60 if quick else 100,
                     seg_rounds=20 if quick else 30, num_clients=10 if quick else 25,
                     out_dir=os.path.join(out_dir, "results"), device=device)
        draco = curves["draco"][-1]
        best_base = max(c[-1] for m, c in curves.items() if m != "draco")
        emit(f"fig3_{task}_draco_final_acc", 0.0,
             f"draco={draco:.3f}_bestbase={best_base:.3f}")


def bench_fig4(quick=False, device=None, out_dir="."):
    """Fig. 4: the Psi sweep, accuracy and oscillation against the cap."""
    from benchmarks.torch_fig4_psi_sweep import run

    res = run("emnist", psis=(1, 4, 24) if quick else (1, 2, 4, 8, 24),
              windows=240 if quick else 600, num_clients=10 if quick else 25,
              out_dir=os.path.join(out_dir, "results"), device=device)
    best_psi = max(res, key=lambda p: res[p]["final_acc"])
    emit("fig4_best_psi", 0.0, f"psi={best_psi}_acc={res[best_psi]['final_acc']:.3f}")


def bench_fig_dynamic(quick=False, device=None, out_dir="."):
    """Scenario engine: accuracy and consensus against topology churn and
    the straggler fraction (writes BENCH_torch_scenarios.json)."""
    from benchmarks.torch_fig_dynamic import run

    res = run("emnist", quick=quick, out_dir=os.path.join(out_dir, "results"),
              bench_json=os.path.join(out_dir, "BENCH_torch_scenarios.json"),
              device=device)
    frozen = res["churn"][0.0]["final_acc"]
    worst_churn = min(r["final_acc"] for r in res["churn"].values())
    worst_strag = min(r["final_acc"] for r in res["straggler"].values())
    emit("fig_dynamic_churn_robustness", 0.0,
         f"frozen={frozen:.3f}_worstchurn={worst_churn:.3f}")
    emit("fig_dynamic_straggler_robustness", 0.0, f"worstfrac={worst_strag:.3f}")


def bench_events(quick=False, device=None, out_dir="."):
    """Event engine: cost per event (one drain launch per valid event)
    against the windowed engine's cost per window at the paper scale (N =
    25), and the staleness-damped variant; also per simulated second.
    Writes BENCH_torch_events.json."""
    from repro_torch.api import simulate
    from repro_torch.events import EventConfig, events_context, simulate_events
    from repro_torch.tasks import get_task

    dev = resolve_device(device)
    n = 8 if quick else 25
    horizon = 4.0 if quick else 10.0
    iters = 2 if quick else 5
    cfg = EventConfig(num_clients=n, lr=0.05, local_batches=1, batch_size=16,
                      lambda_grad=0.3, lambda_tx=0.3, unify_period=50, topology="cycle",
                      max_delay_windows=4, staleness="poly")
    task = get_task("linear-softmax")
    data, _ = task.make_data(torch.Generator(device=dev).manual_seed(1), n)
    params0 = task.init_params(torch.Generator(device=dev).manual_seed(0))
    ctx = events_context(cfg, task=task, data=data, horizon=horizon, params0=params0,
                         device=dev)
    n_events = max(ctx.tape.num_valid, 1)
    rows = {}

    def windowed():
        st, _ = simulate("draco", cfg, task=task, data=data,
                         num_steps=int(horizon / cfg.window), key=0, device=dev)
        return st.window_idx

    us_w = time_fn(windowed, warmup=1, iters=iters) / (horizon / cfg.window)
    emit(f"draco_window_N{n}", us_w, "us_per_window")
    rows["draco_us_per_window"] = us_w
    for algo in ("draco-event", "fedasync-gossip"):

        def run(algo=algo):
            st, _ = simulate_events(algo, cfg, ctx=ctx, key=0, device=dev)
            return st.event_idx

        us_e = time_fn(run, warmup=1, iters=iters) / n_events
        emit(f"{algo}_N{n}", us_e, "us_per_event")
        rows[f"{algo.replace('-', '_')}_us_per_event"] = us_e
        rows[f"{algo.replace('-', '_')}_us_per_sim_s"] = us_e * n_events / horizon
    rows["draco_us_per_sim_s"] = us_w / cfg.window
    rows.update({"num_clients": n, "horizon_s": horizon, "tape_events": n_events,
                 "tape_capacity": ctx.tape.capacity})
    _write(out_dir, "BENCH_torch_events.json", rows)


def _write(out_dir, name, rows):
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1, sort_keys=True)
    print(f"# wrote {path} ({len(rows)} entries)")


BENCHES = {
    "gossip": bench_gossip_mix,
    "ssd": bench_ssd,
    "draco_window": bench_draco_window,
    "simulate_fused": bench_simulate_fused,
    "sweep": bench_sweep,
    "tasks": bench_tasks,
    "events": bench_events,
    "fig3": bench_fig3,
    "fig4": bench_fig4,
    "fig_dynamic": bench_fig_dynamic,
}


def main(argv=None) -> None:
    from benchmarks.torch_common import write_json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None, choices=list(BENCHES))
    ap.add_argument("--json", default=DEFAULT_JSON,
                    help="machine-readable results path ('' to skip)")
    ap.add_argument("--out-dir", default=".",
                    help="directory of the benches' own JSON files and results/")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("name,us_per_call,derived")
    for name, fn in BENCHES.items():
        if args.only and name != args.only:
            continue
        t0 = time.perf_counter()
        fn(quick=args.quick, device=device, out_dir=args.out_dir)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s on {device_label(device)}")
    # a partial (--only) run must not clobber the full-results file; write
    # it only for full sweeps or an explicit --json
    if args.json and not (args.only and args.json == DEFAULT_JSON):
        write_json(args.json)


if __name__ == "__main__":
    main()

"""Dynamic-scenario sweeps on the port: accuracy and consensus against
churn and stragglers (the counterpart of `benchmarks/fig_dynamic.py`).

Two Fig.-4-style sweeps over the scenario engine, DRACO on the
EMNIST-like task with the paper's wireless channel:

  - **churn**: `markov-edge-flip` at rising per-step edge flip rates
    (churn 0 is the frozen graph);
  - **stragglers**: `straggler-profile` at rising straggler fractions
    (10x heavy-tailed slowdowns, 50% duty cycles).

Each family is one `repro_torch.api.simulate_sweep` call over its
schedules (`repro_torch.scenarios.make_schedule`, one per grid row).
Writes ``results/fig_dynamic_{task}.json`` in the reference's schema and
mirrors the final-point scalars to ``BENCH_torch_scenarios.json``. Runs
on CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python -m benchmarks.torch_fig_dynamic --task emnist
  PYTHONPATH=src python -m benchmarks.torch_fig_dynamic --quick
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from benchmarks.torch_fig3_convergence import seed_keys, setup
from benchmarks.torch_common import device_label
from repro_torch import resolve_device
from repro_torch.api import make_context, simulate_sweep
from repro_torch.scenarios import make_schedule

CHURNS = (0.0, 0.05, 0.2, 0.5)
FRACS = (0.0, 0.2, 0.5)


def _total_accept(state):
    return state.total_accept


def _schedule_seed(key: int, salt: int) -> int:
    """The schedule seed of grid point `salt` (the reference folds the
    salt into its key)."""
    return int(np.random.SeedSequence([key, salt]).generate_state(1)[0])


def _sweep_family(cfg, params0, loss, train, test, acc, key, keys, windows,
                  segments, scenario, salts, kwargs_list, ctx, device,
                  metric="accuracy"):
    """One scenario family (one generator, varying knobs) as one sweep
    call over its schedules, one per grid row."""
    scheds = [make_schedule(scenario, cfg, key=_schedule_seed(key, salt), device=device,
                            **kw) for salt, kw in zip(salts, kwargs_list)]
    seg_w = max(1, windows // segments)
    accepted, trace = simulate_sweep(
        "draco", cfg, params0, loss, train, num_steps=segments * seg_w,
        keys=keys, eval_every=seg_w, eval_fn=acc, eval_data=test,
        schedules=scheds, ctx=ctx, final_fn=_total_accept, device=device)
    best = min if metric == "perplexity" else max  # lower ppl is better
    rows = []
    for g in range(len(scheds)):
        accs = [float(a) for a in np.asarray(trace.metrics[metric][g]).mean(axis=0)]
        cons = [float(c) for c in np.asarray(trace.metrics["consensus"][g]).mean(axis=0)]
        rows.append({
            "final_acc": accs[-1],
            "best_acc": best(accs),
            "final_consensus": cons[-1],
            "acc_curve": accs,
            "consensus_curve": cons,
            "msgs": int(accepted[g].sum(dim=-1).double().mean()),
        })
    return rows


def run(task_name="emnist", windows=240, segments=6, seed=0, num_clients=None,
        churns=CHURNS, fracs=FRACS, sched_steps=32, out_dir="results",
        bench_json="BENCH_torch_scenarios.json", quick=False, seeds=1,
        optimizer="sgd", device=None):
    from repro_torch.tasks import is_task

    dev = resolve_device(device)
    t0 = time.perf_counter()
    if quick:
        windows, segments, num_clients = 60, 3, num_clients or 8
        churns, fracs, sched_steps = (0.0, 0.2), (0.0, 0.5), 12
    cfg, train, test, params0, loss, acc, key = setup(task_name, seed, num_clients,
                                                      optimizer=optimizer, device=dev)
    metric = loss.metric_name if is_task(loss) else "accuracy"
    ctx = make_context(cfg, loss, train, params0=params0, device=dev)
    keys = seed_keys(key, seeds)
    churn_rows = _sweep_family(
        cfg, params0, loss, train, test, acc, key, keys, windows, segments,
        "markov-edge-flip", range(len(churns)),
        [{"steps": sched_steps, "churn": float(c)} for c in churns], ctx, dev,
        metric=metric)
    strag_rows = _sweep_family(
        cfg, params0, loss, train, test, acc, key, keys, windows, segments,
        "straggler-profile", [100 + i for i in range(len(fracs))],
        [{"steps": sched_steps, "straggler_frac": float(f), "slowdown": 10.0,
          "duty": 0.5} for f in fracs], ctx, dev, metric=metric)
    results = {
        "churn": {float(c): r for c, r in zip(churns, churn_rows)},
        "straggler": {float(f): r for f, r in zip(fracs, strag_rows)},
    }

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"fig_dynamic_{task_name}.json")
    with open(path, "w") as f:
        json.dump({"task": task_name, "windows": windows, "metric": metric,
                   "results": results}, f, indent=1)
    print(f"# Fig-dynamic scenario sweeps ({task_name}) -> {path}")
    print(f"sweep,knob,final_{metric},best_{metric},final_consensus,msgs")
    bench = {}
    for sweep, rows in results.items():
        for knob, r in rows.items():
            print(f"{sweep},{knob},{r['final_acc']:.4f},{r['best_acc']:.4f},"
                  f"{r['final_consensus']:.4f},{r['msgs']}")
            tag = f"scenario_{sweep}_{knob}"
            bench[f"{tag}_final_acc"] = r["final_acc"]
            bench[f"{tag}_final_consensus"] = r["final_consensus"]
    if bench_json:
        with open(bench_json, "w") as f:
            json.dump(bench, f, indent=1, sort_keys=True)
        print(f"# wrote {bench_json} ({len(bench)} entries)")
    print(f"# {time.perf_counter() - t0:.1f} s on {device_label(dev)}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="emnist",
                    help="paper preset (emnist/poker) or task-registry workload")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "momentum", "adamw"))
    ap.add_argument("--windows", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--bench-json", default="BENCH_torch_scenarios.json",
                    help="final-point scalars ('' to skip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    a = ap.parse_args(argv)
    return run(a.task, windows=a.windows, seed=a.seed, num_clients=a.clients,
               quick=a.quick, seeds=a.seeds, optimizer=a.optimizer, out_dir=a.out_dir,
               bench_json=a.bench_json, device=a.device)


if __name__ == "__main__":
    main()

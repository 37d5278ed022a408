"""Paper Fig. 4 on the port: the effect of the Psi message cap (Gamma_max
= 10 s), the counterpart of `benchmarks/fig4_psi_sweep.py`.

Sweeps Psi and reports accuracy and communication (accepted messages).
The whole grid, every Psi x every seed, is one
`repro_torch.api.simulate_sweep` call: Psi re-bound per grid row, the
seeds of a row in one seed-stacked state (one drain launch per window
for all of them). Writes ``results/fig4_{task}.json`` in the reference's
schema. Runs on CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python -m benchmarks.torch_fig4_psi_sweep --task emnist --seeds 4
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


def _total_accept(state):
    """final_fn: the sweep only needs the per-run message counters."""
    return state.total_accept


def run(task_name="emnist", psis=(1, 2, 4, 8, 24), windows=600, seed=0,
        num_clients=None, out_dir="results", segments=6, seeds=1,
        optimizer="sgd", device=None):
    from repro_torch.tasks import is_task

    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfg0, train, test, params0, loss, acc, key = setup(task_name, seed, num_clients,
                                                       optimizer=optimizer, device=dev)
    metric = loss.metric_name if is_task(loss) else "accuracy"
    seg_w = max(1, windows // segments)
    grid = [cfg0.replace(psi=int(p)) for p in psis]
    ctx = make_context(grid[0], loss, train, params0=params0, device=dev)
    accepted, trace = simulate_sweep(
        "draco", grid, params0, loss, train, num_steps=segments * seg_w,
        keys=seed_keys(key, seeds), eval_every=seg_w, eval_fn=acc, eval_data=test,
        ctx=ctx, final_fn=_total_accept, device=dev)  # accepted: (G, R, N)

    best = min if metric == "perplexity" else max  # lower ppl is better
    results = {}
    for g, psi in enumerate(psis):
        accs = [float(a) for a in np.asarray(trace.metrics[metric][g]).mean(axis=0)]
        results[int(psi)] = {
            "final_acc": accs[-1],
            "best_acc": best(accs),
            "acc_curve": accs,
            "msgs": int(accepted[g].sum(dim=-1).double().mean()),
            "osc": float(np.std(np.diff(np.asarray(accs[2:], np.float32))))
            if len(accs) > 3 else 0.0,
        }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"fig4_{task_name}.json")
    with open(path, "w") as f:
        # "metric" names what final_acc/best_acc hold (fig3's convention)
        json.dump({"task": task_name, "metric": metric, "results": results}, f, indent=1)
    print(f"# Fig4 Psi sweep ({task_name}, {seeds} seed(s)) -> {path}")
    print(f"psi,final_{metric},best_{metric},oscillation")
    for psi, r in results.items():
        print(f"{psi},{r['final_acc']:.4f},{r['best_acc']:.4f},{r['osc']:.4f}")
    print(f"# {time.perf_counter() - t0:.1f} s on {device_label(dev)}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="emnist",
                    help="paper preset (emnist/poker) or task-registry workload")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "momentum", "adamw"))
    ap.add_argument("--windows", type=int, default=600)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    a = ap.parse_args(argv)
    return run(a.task, windows=a.windows, seed=a.seed, num_clients=a.clients,
               out_dir=a.out_dir, seeds=a.seeds, optimizer=a.optimizer, device=a.device)


if __name__ == "__main__":
    main()

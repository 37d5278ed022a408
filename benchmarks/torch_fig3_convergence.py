"""Paper Fig. 3 on the port: DRACO against the four baselines over
unreliable wireless (the counterpart of `benchmarks/fig3_convergence.py`).

(a) EMNIST-like task, cycle topology; (b) Poker-like task, complete
topology. Writes ``results/fig3_{task}.json`` in the reference's schema
and prints the final table.

Every method's seed batch is one `repro_torch.api.simulate_sweep` call:
DRACO's seeds ride one seed-stacked state (one drain launch per window
for all seeds), a baseline's seeds run one after another (one mix launch
per round each). Runs on CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python -m benchmarks.torch_fig3_convergence --task emnist --seeds 4
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from benchmarks.torch_common import device_label
from repro_torch import resolve_device
from repro_torch.api import get_algorithm, make_context, simulate_sweep, steps_for_budget
from repro_torch.configs.draco_paper import TASKS
from repro_torch.core.baselines import BASELINES
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.flat import tree_leaves, tree_map
from repro_torch.core.protocol import DracoConfig


def setup(task_name: str, seed: int = 0, num_clients: int = None,
          optimizer: str = "sgd", device=None):
    """Build (cfg, train, test, params0, workload, eval_fn, key), as the
    reference's `setup`.

    `task_name` is a paper preset (`TASKS`: "emnist"/"poker", the bare
    `make_mlp` loss under plain SGD) or a `repro_torch.tasks` registry
    name; for a registry task the workload slot is the `Task`,
    `optimizer` selects its update rule and the wireless message size is
    the model's f32 byte count. `key` is an int seed for the sweep's
    seed rows; the data, params and key come from three seeds of one
    numpy `SeedSequence(seed)`. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    k1, k2, k3 = (int(s) for s in np.random.SeedSequence(seed).generate_state(3))
    if task_name in TASKS:
        from repro_torch.data.synthetic import federated_classification, make_mlp

        t = TASKS[task_name]
        n = num_clients or t.num_clients
        train, test = federated_classification(
            k1, n, input_dim=t.input_dim, num_classes=t.num_classes,
            per_client=t.samples_per_client, device=dev)
        params0, _, loss, acc = make_mlp(k2, t.input_dim, t.hidden, t.num_classes,
                                         device=dev)
        if optimizer != "sgd":
            raise ValueError(
                f"paper preset {task_name!r} is the legacy plain-SGD "
                "path; use a task-registry name to swap optimizers")
        workload, eval_fn = loss, acc
        topology = "cycle" if task_name == "emnist" else "complete"
        message_bytes, lr = t.message_bytes, t.lr
        local_batches, batch_size, lambda_grad = (t.local_batches, t.batch_size,
                                                  t.lambda_grad)
    else:
        from repro_torch.tasks import get_task

        task = get_task(task_name, optimizer=optimizer)
        n = num_clients or 25
        params0, train, test = task.setup(k1, n, device=dev)
        workload, eval_fn = task, task.eval_fn
        topology = "cycle"
        message_bytes = 4 * sum(leaf.numel() for leaf in tree_leaves(params0))
        lr, local_batches, batch_size, lambda_grad = 0.05, 1, 64, 0.1
    chan = ChannelConfig(message_bytes=message_bytes, gamma_max=10.0)
    # psi scales with in-degree (fig4 sweeps it): the cycle has 2
    # in-neighbors, complete n - 1, where a tiny fixed cap starves it
    psi = 6 if topology == "cycle" else 0
    cfg = DracoConfig(num_clients=n, lr=lr, local_batches=local_batches,
                      batch_size=batch_size, lambda_grad=lambda_grad,
                      lambda_tx=lambda_grad, unify_period=50, psi=psi,
                      topology=topology, max_delay_windows=4, channel=chan)
    return cfg, train, test, params0, workload, eval_fn, k3


def seed_keys(key: int, seeds: int) -> list:
    """The sweep's seed rows: `seeds <= 1` keeps the base key itself (the
    single run), more seeds are split from it."""
    from repro_torch.api.sweep import seed_keys as split

    return [key] if seeds <= 1 else split(key, seeds)


def eval_one(eval_fn, params0, test) -> float:
    """The metric of one client's params (a stack of one client)."""
    return float(eval_fn(tree_map(lambda p: p[None], params0), test[0], test[1])[0])


def _discard(state):
    """final_fn: the figure only reads the trace."""
    return ()


def run(task_name="emnist", segments=8, seg_windows=100, seg_rounds=None,
        seed=0, num_clients=None, out_dir="results", seeds=1,
        optimizer="sgd", device=None):
    """Compute-matched comparison, as the reference's `run`: every method
    gets the same expected local compute per client per segment
    (`steps_for_budget`; FLOP-priced through `task.grad_cost` for registry
    tasks). Curves are seed means; returns {method: curve}."""
    from repro_torch.tasks import is_task

    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfg, train, test, params0, workload, eval_fn, key = setup(
        task_name, seed, num_clients, optimizer=optimizer, device=dev)
    keys = seed_keys(key, seeds)
    task = workload if is_task(workload) else None
    metric = task.metric_name if task is not None else "accuracy"

    cost = task.grad_cost if task is not None else 1.0
    budget = seg_windows * get_algorithm("draco").grads_per_step(cfg) * cost
    ctx = make_context(cfg, workload, train, params0=params0, device=dev)
    # every method starts from params0 on every client (push weights 1)
    m0 = eval_one(eval_fn, params0, test)
    curves = {}
    for name in ("draco",) + tuple(BASELINES):
        if name == "draco":
            per_seg = seg_windows
        else:
            per_seg = seg_rounds or steps_for_budget(name, cfg, budget, task=task)
        _, trace = simulate_sweep(name, cfg, params0, workload, train,
                                  num_steps=segments * per_seg, keys=keys,
                                  eval_every=per_seg, eval_fn=eval_fn, eval_data=test,
                                  ctx=ctx, final_fn=_discard, device=dev)
        seed_mean = np.asarray(trace.metrics[metric][0]).mean(axis=0)
        curves[name] = [m0] + [float(a) for a in seed_mean]

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"fig3_{task_name}.json")
    with open(path, "w") as f:
        json.dump({"task": task_name, "topology": cfg.topology,
                   "metric": metric, "curves": curves}, f, indent=1)
    print(f"# Fig3 ({task_name}, {cfg.topology} topology, {seeds} seed(s)) -> {path}")
    print(f"method,final_{metric},best_{metric}")
    best = min if metric == "perplexity" else max
    for m, c in curves.items():
        print(f"{m},{c[-1]:.4f},{best(c):.4f}")
    print(f"# {time.perf_counter() - t0:.1f} s on {device_label(dev)}")
    return curves


def main(argv=None):
    from repro_torch.tasks import list_tasks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="emnist", choices=list(TASKS) + list(list_tasks()),
                    help="paper preset (emnist/poker) or task-registry workload")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "momentum", "adamw"),
                    help="local update rule (task-registry workloads only)")
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="seed rows of the sweep (curves are means)")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    a = ap.parse_args(argv)
    return run(a.task, segments=a.segments, seed=a.seed,
               num_clients=a.clients, out_dir=a.out_dir, seeds=a.seeds,
               optimizer=a.optimizer, device=a.device)


if __name__ == "__main__":
    main()

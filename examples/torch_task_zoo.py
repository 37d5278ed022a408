"""Task zoo tour on the port: one algorithm, four workloads, three
optimizers (the counterpart of `examples/task_zoo.py`).

Runs DRACO over the wireless-free cycle graph on every registered task
(`linear-softmax`, `mlp`, `small-cnn`, `tiny-lm`), each as one
`simulate()` call with the task's metric sampled on the device, then
swaps the local optimizer on the MLP task (sgd / momentum / adamw) to
show the per-client optimizer state riding the flat plane. Runs on
CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python examples/torch_task_zoo.py
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.api import simulate
from repro_torch.core.protocol import DracoConfig
from repro_torch.tasks import get_task, list_tasks, opt_width


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--windows", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, windows = args.clients, args.windows
    cfg = DracoConfig(num_clients=n, lr=0.05, lambda_grad=0.5, lambda_tx=0.5,
                      unify_period=50, psi=0, topology="cycle", max_delay_windows=4)

    rows = {}
    print(f"== every task, DRACO, N={n}, {windows} windows ==")
    print("task,metric,start,end")
    for name in list_tasks():
        task = get_task(name)
        _, trace = simulate("draco", cfg.replace(lr=0.01 if name == "tiny-lm" else 0.05),
                            task=task, num_steps=windows, key=0,
                            eval_every=max(1, windows // 2), device=dev)
        m = trace.metrics[task.metric_name]
        rows[name] = (float(m[0]), float(m[-1]))
        print(f"{name},{task.metric_name},{float(m[0]):.4f},{float(m[-1]):.4f}")

    print("\n== optimizer axis on the mlp task (state on the flat plane) ==")
    print("optimizer,Dopt,final_acc")
    for opt in ("sgd", "momentum", "adamw"):
        task = get_task("mlp", optimizer=opt)
        # momentum's effective step is ~1/(1-beta) larger; adamw is scale-free
        lr = {"sgd": 0.05, "momentum": 0.01, "adamw": 0.005}[opt]
        st, trace = simulate("draco", cfg.replace(lr=lr), task=task,
                             num_steps=windows, key=0, eval_every=windows, device=dev)
        dopt = opt_width(task, task.init_params(torch.Generator(device=dev).manual_seed(0)))
        assert st.opt_state.shape == (n, dopt)
        rows[opt] = float(trace.metrics["accuracy"][-1])
        print(f"{opt},{dopt},{rows[opt]:.4f}")
    return rows


if __name__ == "__main__":
    main()

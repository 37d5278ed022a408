"""Quickstart on the port: DRACO at the paper's experiment scale, via
`repro_torch.api` (the counterpart of `examples/quickstart.py`).

25 clients, EMNIST-like federated classification, cycle topology,
unreliable wireless channel, Psi message cap: the whole Algorithm 1
pipeline through one `simulate(...)` call, 600 windows, one drain-kernel
launch per window, accuracy and consensus distance sampled on the
device. Runs on CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python examples/torch_quickstart.py
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.api import get_algorithm, list_algorithms, simulate
from repro_torch.configs.draco_paper import EMNIST
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.flat import tree_leaves
from repro_torch.core.protocol import DracoConfig, virtual_global_model
from repro_torch.data import federated_classification, make_mlp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=25)
    ap.add_argument("--windows", type=int, default=600)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t = EMNIST
    n = args.clients
    g = torch.Generator(device=dev).manual_seed(0)

    print(f"== DRACO quickstart: {n} clients, {t.name}-like task, cycle topology ==")
    print(f"registered algorithms: {', '.join(list_algorithms())}")
    train, test = federated_classification(
        g, n, input_dim=t.input_dim, num_classes=t.num_classes,
        per_client=t.samples_per_client)
    params0, apply, loss, acc = make_mlp(g, t.input_dim, t.hidden, t.num_classes)
    n_params = sum(x.numel() for x in tree_leaves(params0))
    print(f"model: MLP {t.hidden}, {n_params} params "
          f"(paper CNN: ~{t.message_bytes} B)")

    cfg = DracoConfig(
        num_clients=n, lr=t.lr, local_batches=t.local_batches,
        batch_size=t.batch_size, lambda_grad=0.3, lambda_tx=0.3,
        unify_period=50, psi=6, topology="cycle", max_delay_windows=4,
        channel=ChannelConfig(message_bytes=t.message_bytes, gamma_max=10.0))

    st, trace = simulate("draco", cfg, params0, loss, train, num_steps=args.windows,
                         key=1, eval_every=max(1, args.windows // 6), eval_fn=acc,
                         eval_data=test, device=dev)
    for step, a, c in zip(trace.step, trace.metrics["accuracy"],
                          trace.metrics["consensus"]):
        print(f"window {int(step):4d}: mean client acc {float(a):.3f}, "
              f"consensus distance {float(c):.4f}")

    vg = virtual_global_model(get_algorithm("draco").eval_params(st))
    vg_acc = float(acc({k: v[None] for k, v in vg.items()}, test[0], test[1])[0])
    print(f"virtual-global acc {vg_acc:.3f}, "
          f"msgs accepted total {int(st.total_accept.sum())}")
    print("done — decoupled computation/communication, no global clock, "
          "row-stochastic gossip, Psi-capped reception.")
    return trace


if __name__ == "__main__":
    main()

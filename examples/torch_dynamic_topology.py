"""Dynamic scenarios on the port: DRACO on time-varying networks, via
`repro_torch.api` (the counterpart of `examples/dynamic_topology.py`).

Runs the same DRACO protocol under all four registered scenario
generators (the frozen graph, Markov edge churn, random-waypoint
mobility with the graph re-derived from channel geometry each epoch,
and a heavy-tailed straggler profile) and prints a side-by-side table of
accuracy and consensus distance. Each run is one `simulate` call; every
window reads its step's snapshot of the schedule's rings. Runs on CUDA;
``--device cpu`` on purpose.

  PYTHONPATH=src python examples/torch_dynamic_topology.py
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.api import simulate
from repro_torch.configs.draco_paper import EMNIST
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.protocol import DracoConfig
from repro_torch.data import federated_classification, make_mlp
from repro_torch.scenarios import list_scenarios

SCENARIOS = {
    "static": {},
    "markov-edge-flip": {"steps": 32, "churn": 0.2},
    "random-waypoint": {"steps": 32, "speed": 40.0},
    "straggler-profile": {"steps": 32, "straggler_frac": 0.4,
                          "slowdown": 10.0, "duty": 0.5},
}

# psi must track in-degree: the cycle-based scenarios have 2
# in-neighbors, but random-waypoint's geometric graph links ~half the
# disk, where a small fixed cap starves it, so the cap is lifted there
# (psi=0 = unbounded).
PSI = {"random-waypoint": 0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t = EMNIST
    n, windows = args.clients, args.windows
    g = torch.Generator(device=dev).manual_seed(0)

    print(f"== DRACO under dynamic scenarios: {n} clients, {windows} windows ==")
    print(f"registered scenarios: {', '.join(list_scenarios())}")
    train, test = federated_classification(
        g, n, input_dim=t.input_dim, num_classes=t.num_classes,
        per_client=t.samples_per_client)
    params0, apply, loss, acc = make_mlp(g, t.input_dim, t.hidden, t.num_classes)
    cfg = DracoConfig(
        num_clients=n, lr=t.lr, local_batches=t.local_batches,
        batch_size=t.batch_size, lambda_grad=0.3, lambda_tx=0.3,
        unify_period=50, psi=6, topology="cycle", max_delay_windows=4,
        channel=ChannelConfig(message_bytes=t.message_bytes, gamma_max=10.0))

    rows = {}
    print(f"{'scenario':<20} {'final acc':>9} {'consensus':>9} {'msgs':>7}")
    for name, knobs in SCENARIOS.items():
        cfg_s = cfg.replace(psi=PSI.get(name, cfg.psi))
        st, trace = simulate("draco", cfg_s, params0, loss, train,
                             num_steps=windows, key=1, eval_every=max(1, windows // 3),
                             eval_fn=acc, eval_data=test, scenario=name,
                             scenario_key=2, scenario_kwargs=knobs, device=dev)
        a = float(trace.metrics["accuracy"][-1])
        c = float(trace.metrics["consensus"][-1])
        rows[name] = a
        print(f"{name:<20} {a:>9.3f} {c:>9.4f} {int(st.total_accept.sum()):>7}")
    print("done — one simulator, four workloads: churn, mobility and "
          "stragglers ride the same window loop as the frozen graph.")
    return rows


if __name__ == "__main__":
    main()

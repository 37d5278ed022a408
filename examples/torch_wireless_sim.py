"""Faithful continuous-time DRACO simulation on the port (paper
Algorithm 2; the counterpart of `examples/wireless_sim.py`).

Unlike the superposition-window engine (`repro_torch.core.protocol`),
this example runs the exact event-driven timeline: per-client Poisson
event lists are generated with numpy, merged and sorted
(`repro_torch.core.events.event_list`, Alg. 2 lines 1-15), then
processed one event at a time with real-valued SINR transmission delays,
the semantics the windowed engine approximates. At the end it runs the
windowed engine on the same setup through `repro_torch.api.simulate`
(one window per second of horizon) to show the two agree. Runs on CUDA;
``--device cpu`` on purpose.

  PYTHONPATH=src python examples/torch_wireless_sim.py
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.channel import ChannelConfig, place_nodes, transmission_delays
from repro_torch.core.events import event_list
from repro_torch.core.flat import tree_map
from repro_torch.core.topology import adjacency
from repro_torch.data import federated_classification, make_mlp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--horizon", type=float, default=400.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, horizon = args.clients, args.horizon
    lam_grad = lam_tx = 0.1
    unify_period = 100.0
    psi = 4
    chan = ChannelConfig(message_bytes=51_640, gamma_max=10.0)

    g = torch.Generator(device=dev).manual_seed(0)
    train, test = federated_classification(g, n, input_dim=10, num_classes=5,
                                           per_client=300)
    xs, ys = train
    tx_t, ty_t = test
    params0, apply, loss_fn, acc = make_mlp(g, 10, (32,), 5)

    def grad_fn(p, x, y):
        """One client's gradient of its batch mean loss (a stack of one)."""
        leaves = {k: v[None].detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, x[None], y[None]).sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return {k: gr[0] for k, gr in zip(leaves, grads)}

    adj = adjacency("cycle", n, device=dev).cpu().numpy()
    pos = place_nodes(g, n, chan)
    rng = np.random.default_rng(0)

    evs = event_list(rng, n, horizon, lam_grad, lam_tx, unify_period)
    print(f"== event-driven DRACO: {len(evs)} events over {horizon}s, {n} clients ==")

    params = [tree_map(lambda x: x.clone(), params0) for _ in range(n)]
    pending = [tree_map(torch.zeros_like, params0) for _ in range(n)]
    inflight = []  # (arrive_t, dst, weight, delta)
    accepted = np.zeros(n, int)
    period_start = 0.0
    lr, bs = 0.1, 32
    stats = {"grad": 0, "tx": 0, "delivered": 0, "dropped_deadline": 0,
             "dropped_psi": 0, "unify": 0}
    g_fading = torch.Generator(device=dev)

    for ev in evs:
        # deliveries due before this event
        for msg in [m for m in inflight if m[0] <= ev.t]:
            inflight.remove(msg)
            _, dst, w, delta = msg
            if accepted[dst] >= psi:
                stats["dropped_psi"] += 1
                continue
            params[dst] = tree_map(lambda p, d: p + w * d, params[dst], delta)
            accepted[dst] += 1
            stats["delivered"] += 1

        if ev.t - period_start >= unify_period:
            accepted[:] = 0
            period_start += unify_period

        i = ev.client
        if ev.kind == "grad":
            idx = torch.as_tensor(rng.integers(0, xs.shape[1], size=bs), device=dev)
            gr = grad_fn(params[i], xs[i, idx], ys[i, idx])
            pending[i] = tree_map(lambda a, b: a - lr * b, pending[i], gr)
            stats["grad"] += 1
        elif ev.kind == "tx":
            tx_mask = torch.zeros(n, dtype=torch.bool, device=dev)
            tx_mask[i] = True
            # the link fading of this transmission, seeded by its time
            g_fading.manual_seed(int(ev.t * 1e3) % (2**31))
            fading = torch.empty((n, n), device=dev).exponential_(generator=g_fading)
            gamma, succ = transmission_delays(fading, pos, tx_mask, chan)
            gamma, succ = gamma.cpu().numpy(), succ.cpu().numpy()
            nbrs = np.where(adj[i])[0]
            w = 1.0 / max(len(nbrs), 1)  # row-stochastic split
            for j in nbrs:
                if succ[i, j]:
                    inflight.append((ev.t + float(gamma[i, j]), int(j), w, pending[i]))
                else:
                    stats["dropped_deadline"] += 1
            pending[i] = tree_map(torch.zeros_like, pending[i])
            stats["tx"] += 1
        elif ev.kind == "unify":
            for j in range(n):
                if j != i:
                    params[j] = tree_map(lambda x: x.clone(), params[i])
            stats["unify"] += 1

    stacked = tree_map(lambda *ps: torch.stack(ps), *params)
    accs = acc(stacked, tx_t, ty_t).cpu().numpy()
    print(f"events: {stats}")
    print(f"final mean client accuracy: {np.mean(accs):.3f} (std {np.std(accs):.4f})")
    assert np.mean(accs) > 0.3

    # --- cross-check: the windowed engine on the same setup ----------------
    from repro_torch.api import simulate
    from repro_torch.core.protocol import DracoConfig

    cfg = DracoConfig(num_clients=n, lr=lr, local_batches=1, batch_size=bs,
                      lambda_grad=lam_grad, lambda_tx=lam_tx,
                      unify_period=int(unify_period), psi=psi,
                      topology="cycle", max_delay_windows=4, channel=chan)
    st, trace = simulate("draco", cfg, params0, loss_fn, train, num_steps=int(horizon),
                         key=0, eval_every=max(1, int(horizon) // 4), eval_fn=acc,
                         eval_data=test, device=dev)
    w_acc = float(trace.metrics["accuracy"][-1])
    print(f"windowed engine (repro_torch.api.simulate, {int(horizon)} "
          f"windows): mean client accuracy {w_acc:.3f}")
    assert w_acc > 0.3
    return float(np.mean(accs)), w_acc


if __name__ == "__main__":
    main()

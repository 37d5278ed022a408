"""Seed x Psi sweep in one `repro_torch.api.simulate_sweep` call (the
counterpart of `examples/seed_sweep.py`).

The paper's claims are statements about sweeps, so the sweep is the unit
of work: a 4-seed x 3-Psi DRACO grid (12 runs) in one call. A row's four
seeds ride one seed-stacked state, advanced by one drain launch per
window for all of them (row k equals the solo `simulate()` with that
seed); Psi is re-bound per grid row; accuracy and consensus are sampled
on the device. Runs on CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python examples/torch_seed_sweep.py
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import make_context, simulate_sweep
from repro_torch.api.sweep import seed_keys
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.protocol import DracoConfig
from repro_torch.data import federated_classification, make_mlp

SEEDS, PSIS, WINDOWS, EVERY = 4, (1, 4, 24), 120, 40


def total_accept(state):
    """final_fn: keep only the message counters of the grid states."""
    return state.total_accept


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, windows = args.clients, args.windows
    every = min(EVERY, windows)
    g = torch.Generator(device=dev).manual_seed(0)
    train, test = federated_classification(g, n, input_dim=16, num_classes=5,
                                           per_client=128)
    params0, apply, loss, acc = make_mlp(g, 16, (32,), 5)
    cfg = DracoConfig(
        num_clients=n, lr=0.05, local_batches=1, batch_size=16,
        lambda_grad=0.3, lambda_tx=0.3, unify_period=50, psi=PSIS[0],
        topology="cycle", max_delay_windows=4,
        channel=ChannelConfig(message_bytes=13_000, gamma_max=10.0))
    grid = [cfg.replace(psi=p) for p in PSIS]
    ctx = make_context(grid[0], loss, train, params0=params0, device=dev)

    print(f"== simulate_sweep: {SEEDS} seeds x {len(PSIS)} Psi values, "
          f"{windows} windows, one call ==")
    msgs, trace = simulate_sweep(
        "draco", grid, params0, loss, train, num_steps=windows,
        keys=seed_keys(1, SEEDS), eval_every=every, eval_fn=acc,
        eval_data=test, ctx=ctx, final_fn=total_accept, device=dev)

    accs = trace.metrics["accuracy"]  # (G, R, E)
    print("psi,final_acc_mean,final_acc_std,consensus_mean,msgs_mean")
    for gi, psi in enumerate(PSIS):
        final = accs[gi, :, -1]
        cons = trace.metrics["consensus"][gi, :, -1]
        print(f"{psi},{final.mean():.3f},{final.std():.3f},"
              f"{cons.mean():.4f},{np.asarray(msgs[gi].cpu()).sum(-1).mean():.0f}")
    print("done — seed means with error bars from one call; "
          "swap `schedules=` in for churn/straggler grids.")
    return trace


if __name__ == "__main__":
    main()

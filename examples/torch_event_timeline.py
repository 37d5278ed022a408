"""The continuous-time event engine on the port: exact timelines, via
`repro_torch.events` (the counterpart of `examples/event_timeline.py`).

The windowed engine discretizes DRACO's merged Poisson process into
superposition windows; `simulate_events` keeps the exact timeline: the
run is pre-sampled on the host into a sorted event tape and walked one
event at a time, each valid event draining through the drain kernel.
This example runs the whole event family on one tape and compares it
with the windowed engine at the same rates, horizon and task:

  draco-event       exact-timeline DRACO;
  fedasync-gossip   + FedAsync staleness damping at the exact
                    continuous message age;
  event-triggered   + threshold broadcast suppression (watch the
                    broadcasts drop while accuracy holds);
  draco (windowed)  the superposition-window discretization.

Runs on CUDA; ``--device cpu`` on purpose.

  PYTHONPATH=src python examples/torch_event_timeline.py
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.api import simulate, simulate_events
from repro_torch.events import EventConfig, events_context
from repro_torch.tasks import get_task


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--horizon", type=float, default=40.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, horizon = args.clients, args.horizon
    cfg = EventConfig(
        num_clients=n, lr=0.1, local_batches=1, batch_size=32,
        lambda_grad=0.6, lambda_tx=0.6, unify_period=20, psi=4,
        topology="cycle", max_delay_windows=4,
        staleness="poly", staleness_a=0.5,     # fedasync-gossip knobs
        trigger_threshold=0.15,                # event-triggered knob
    )
    task = get_task("linear-softmax")
    data, eval_data = task.make_data(torch.Generator(device=dev).manual_seed(1), n)
    params0 = task.init_params(torch.Generator(device=dev).manual_seed(0))

    # one tape, shared by every event algorithm: same timeline, so the
    # comparison isolates the algorithmic difference
    ctx = events_context(cfg, task=task, data=data, params0=params0, horizon=horizon,
                         device=dev)
    print(f"tape: {ctx.tape.num_valid} events "
          f"(capacity {ctx.tape.capacity}) over {horizon:.0f}s "
          f"-> {ctx.tape.counts()}")

    rows = {}
    print(f"\n{'algorithm':>18} {'accuracy':>9} {'broadcasts':>11}")
    for algo in ("draco-event", "fedasync-gossip", "event-triggered"):
        st, trace = simulate_events(algo, cfg, ctx=ctx, key=0,
                                    eval_every=ctx.tape.capacity,
                                    eval_data=eval_data, device=dev)
        acc = float(trace.metrics[task.metric_name][-1])
        sent = int(st.tx_sent.sum())
        rows[algo] = (acc, sent)
        print(f"{algo:>18} {acc:9.3f} {sent:11d}")

    # the windowed view of the same process: one step per window
    st, trace = simulate("draco", cfg, task=task, data=data,
                         num_steps=int(horizon / cfg.window), key=0,
                         eval_every=int(horizon / cfg.window), eval_data=eval_data,
                         device=dev)
    acc = float(trace.metrics[task.metric_name][-1])
    rows["draco (windowed)"] = (acc, None)
    print(f"{'draco (windowed)':>18} {acc:9.3f} {'':>11}")
    return rows


if __name__ == "__main__":
    main()

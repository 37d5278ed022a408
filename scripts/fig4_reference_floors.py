"""The JAX reference at the setups of ``chip_smoke.py``'s phases 13 (the
Fig. 4 Psi sweep) and 14 (the event engine), on the CPU: the source of
the accuracy floors and of the event-triggered threshold that
``chip_smoke.py`` holds the port to.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/fig4_reference_floors.py \
        [--setups 2] [--only sweep,events]

Sweep: ``benchmarks/fig4_psi_sweep.py``'s grid, Psi in {1, 2, 4, 8, 24},
at ``benchmarks/fig3_convergence.py:setup("emnist", s)`` (25 clients on
the cycle, MLP 784-160-100-47, the wireless channel with 596,776-byte
messages and Gamma_max 10 s, lr 0.05, batch 64, lambda 0.1, D = 4, P =
50) for each setup seed s, 4 seeds each (`seed_keys`), 120 windows with
an eval every 20, as one `simulate_sweep` call per setup. Prints each
(Psi, seed)'s final accuracy and each Psi's smallest; the floor is 0.8 x
the smallest.

Events: the same setup (seed 0) as an `EventConfig` with poly staleness
(a = 0.5), one tape of horizon 300 s per tape seed. First the
event-triggered threshold. Any positive threshold suppresses the TX rows
of an empty backlog (a client with no gradient event since its last
broadcast), so the script measures that share at 1e-6 and takes the
smallest of ``--thresholds`` that suppresses at least ``--min-share``
more of the TX rows of tape seed 0. Then draco-event, fedasync-gossip
and event-triggered (at that threshold) on 3 tape seeds: each final
accuracy, each algorithm's smallest and its floor, 0.8 x the smallest.
"""
import argparse
import dataclasses
import sys

import jax
import numpy as np

PSIS = (1, 2, 4, 8, 24)
EVENT_ALGOS = ("draco-event", "fedasync-gossip", "event-triggered")


def _discard(state):
    """final_fn: only the trace is read."""
    return ()


def sweep(args):
    from benchmarks.fig3_convergence import seed_keys, setup

    from repro.api import simulate_sweep

    worst = {p: 1.0 for p in PSIS}
    for s in range(args.setups):
        cfg, train, test, params0, loss, acc, key = setup("emnist", s)
        grid = [cfg.replace(psi=p) for p in PSIS]
        _, trace = simulate_sweep("draco", grid, params0, loss, train,
                                  num_steps=args.windows, keys=seed_keys(key, args.seeds),
                                  eval_every=args.eval_every, eval_fn=acc, eval_data=test,
                                  final_fn=_discard)
        final = np.asarray(trace.metrics["accuracy"])[:, :, -1]  # (G, R)
        for g, p in enumerate(PSIS):
            row = " ".join(f"{a:.4f}" for a in final[g])
            print(f"sweep setup {s} psi {p}: final accuracy by seed {row}, seed mean "
                  f"{final[g].mean():.4f}", flush=True)
            worst[p] = min(worst[p], float(final[g].min()))
    for p in PSIS:
        print(f"sweep psi {p}: smallest final accuracy {worst[p]:.4f}, floor "
              f"{0.8 * worst[p]:.4f}")


def _events_setup():
    from benchmarks.fig3_convergence import setup

    from repro.events import EventConfig

    cfg, train, test, params0, loss, acc, key = setup("emnist", 0)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return (EventConfig(**fields, staleness="poly", staleness_a=0.5), train, test, params0,
            loss, acc, key)


def _run_event(algo, cfg, train, test, params0, loss, acc, key, tape_seed, horizon):
    from repro.events import events_context, simulate_events

    ctx = events_context(cfg, loss, train, params0=params0, horizon=horizon,
                         tape_seed=tape_seed)
    st, trace = simulate_events(algo, cfg, params0=params0, ctx=ctx, key=key,
                                eval_every=ctx.tape.capacity, eval_fn=acc, eval_data=test)
    return st, float(trace.metrics["accuracy"][-1]), ctx.tape


def events(args):
    cfg, train, test, params0, loss, acc, key = _events_setup()
    threshold, empty = None, None
    for th in [1e-6] + args.thresholds:
        c = cfg.replace(trigger_threshold=th)
        st, a, tape = _run_event("event-triggered", c, train, test, params0, loss, acc, key,
                                 0, args.horizon)
        sent, rows = int(np.asarray(st.tx_sent).sum()), tape.counts()["tx"]
        share = 1.0 - sent / max(rows, 1)
        print(f"events threshold {th}: {sent} of {rows} TX rows fired ({100 * share:.1f}% "
              f"suppressed), final accuracy {a:.4f}", flush=True)
        if empty is None:
            empty = share  # the empty backlogs' share
        elif share >= empty + args.min_share:
            threshold = th
            break
    if threshold is None:
        raise SystemExit("no threshold suppresses enough TX rows; widen --thresholds")
    print(f"events trigger threshold: {threshold}")
    cfg = cfg.replace(trigger_threshold=threshold)
    worst = {a: 1.0 for a in EVENT_ALGOS}
    for tape_seed in range(args.tapes):
        for algo in EVENT_ALGOS:
            st, a, tape = _run_event(algo, cfg, train, test, params0, loss, acc, key,
                                     tape_seed, args.horizon)
            print(f"events tape {tape_seed} {algo}: {tape.num_valid} events {tape.counts()}, "
                  f"final accuracy {a:.4f}, {int(np.asarray(st.tx_sent).sum())} broadcasts",
                  flush=True)
            worst[algo] = min(worst[algo], a)
    for algo in EVENT_ALGOS:
        print(f"events {algo}: smallest final accuracy {worst[algo]:.4f}, floor "
              f"{0.8 * worst[algo]:.4f}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="sweep,events")
    parser.add_argument("--setups", type=int, default=2)
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--windows", type=int, default=120)
    parser.add_argument("--eval-every", type=int, default=20)
    parser.add_argument("--horizon", type=float, default=300.0)
    parser.add_argument("--tapes", type=int, default=3)
    parser.add_argument("--thresholds", type=lambda s: [float(x) for x in s.split(",")],
                        default=[0.05, 0.1, 0.2, 0.4, 0.8, 1.6])
    parser.add_argument("--min-share", type=float, default=0.1)
    args = parser.parse_args(argv)
    parts = args.only.split(",")
    if "sweep" in parts:
        sweep(args)
    if "events" in parts:
        events(args)
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())

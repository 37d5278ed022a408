"""The JAX reference's final accuracy for each of the four baselines at the
fig3 EMNIST setup, on the CPU, over a few seeds: the source of the
accuracy floors that ``chip_smoke.py`` holds the port's baselines to.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/fig3_reference_floors.py [--seeds 3]

The setup is ``benchmarks/fig3_convergence.py:setup("emnist")`` (25
clients on the cycle, MLP 784-160-100-47, the wireless channel with
596,776-byte messages and Gamma_max 10 s, lr 0.05, batch 64, B = 1,
lambda 0.1); each method runs the rounds that match 300 DRACO windows of
local compute (`steps_for_budget`). Prints one line per method and seed,
then each method's smallest final accuracy.
"""
import argparse
import sys

import jax


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--windows", type=int, default=300)
    args = parser.parse_args(argv)
    from benchmarks.fig3_convergence import setup

    from repro.api import get_algorithm, simulate, steps_for_budget
    from repro.core.baselines import BASELINES

    worst = {}
    for seed in range(args.seeds):
        cfg, train, test, params0, loss, acc, key = setup("emnist", seed)
        budget = args.windows * get_algorithm("draco").grads_per_step(cfg)
        for method in BASELINES:
            rounds = steps_for_budget(method, cfg, budget)
            _, trace = simulate(method, cfg, params0, loss, train, rounds, key=key,
                                eval_every=rounds, eval_fn=acc, eval_data=test)
            final = float(trace.metrics["accuracy"][-1])
            worst[method] = min(worst.get(method, 1.0), final)
            print(f"seed {seed} {method}: {rounds} rounds, final accuracy {final:.4f}",
                  flush=True)
    for method, a in worst.items():
        print(f"{method}: smallest final accuracy over {args.seeds} seeds {a:.4f}")
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())

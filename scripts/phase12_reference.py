"""The JAX reference at the setups of ``chip_smoke.py`` phase 12, on the
CPU, over a few seeds: what that phase's printed metrics compare with.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/phase12_reference.py [--seeds 3] [--only RUNS] [--lr LR]

The setup is ``examples/quickstart.py``'s EMNIST configuration (25 clients
on the cycle, the wireless channel with 596,776-byte messages and
Gamma_max 10 s, lr 0.05, batch 64, B = 1, lambda 0.3, Psi 6, D 4, P 50)
for 240 windows, with `benchmarks/fig_dynamic.py`'s scenario knobs (rings
of period 32): the EMNIST MLP (784-160-100-47, plain SGD) under
markov-edge-flip (churn 0.2), straggler-profile (fraction 0.5, slowdown
10, duty 0.5) and random-waypoint; tiny-lm (AdamW, warmup-cosine over
the run, 24 warmup windows) under random-waypoint; small-cnn (Nesterov
momentum) under straggler-profile. Prints, per run and seed, the metric
(mean client accuracy or perplexity on the shared eval set) and the mean
client loss on its own shard, before and after.
"""
import argparse
import sys

import jax
import jax.numpy as jnp

WINDOWS = 240
KNOBS = {
    "markov-edge-flip": dict(steps=32, churn=0.2),
    "straggler-profile": dict(steps=32, straggler_frac=0.5, slowdown=10.0, duty=0.5),
    "random-waypoint": dict(steps=32),
}
EMNIST_MLP = dict(input_dim=784, hidden=(160, 100), num_classes=47, per_client=1000)
RUNS = {
    "emnist-markov": ("mlp", EMNIST_MLP, "markov-edge-flip"),
    "emnist-straggler": ("mlp", EMNIST_MLP, "straggler-profile"),
    "emnist-waypoint": ("mlp", EMNIST_MLP, "random-waypoint"),
    "tiny-lm": ("tiny-lm", dict(optimizer="adamw", schedule="warmup-cosine",
                                schedule_kwargs={"warmup": 24, "total_steps": WINDOWS}),
                "random-waypoint"),
    "small-cnn": ("small-cnn", dict(optimizer="momentum", opt_kwargs={"nesterov": True}),
                  "straggler-profile"),
}


def config():
    from repro.configs.draco_paper import EMNIST
    from repro.core.channel import ChannelConfig
    from repro.core.protocol import DracoConfig

    return DracoConfig(
        num_clients=EMNIST.num_clients, lr=EMNIST.lr, local_batches=EMNIST.local_batches,
        batch_size=EMNIST.batch_size, lambda_grad=0.3, lambda_tx=0.3, unify_period=50,
        psi=6, topology="cycle", max_delay_windows=4,
        channel=ChannelConfig(message_bytes=EMNIST.message_bytes, gamma_max=10.0))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--only", default=",".join(RUNS), help="runs, comma-separated")
    parser.add_argument("--lr", type=float, default=None,
                        help="the config's lr (default: EMNIST's, 0.05)")
    args = parser.parse_args(argv)
    from repro.api import simulate
    from repro.tasks import get_task

    cfg = config() if args.lr is None else config().replace(lr=args.lr)
    for run in args.only.split(","):
        name, task_kw, scenario = RUNS[run]
        task = get_task(name, **task_kw)
        for seed in range(args.seeds):
            kp, kd = jax.random.split(jax.random.PRNGKey(seed))
            params0 = task.init_params(kp)
            train, test = task.make_data(kd, cfg.num_clients)

            def own_loss(params):
                return float(jnp.mean(jax.vmap(task.loss_fn)(params, *train)))

            stacked = jax.tree_util.tree_map(
                lambda p: jnp.broadcast_to(p, (cfg.num_clients,) + p.shape), params0)
            before, loss0 = float(task.eval_fn(params0, *test)), own_loss(stacked)
            state, trace = simulate("draco", cfg, params0, data=train, num_steps=WINDOWS,
                                    task=task, key=jax.random.PRNGKey(100 + seed),
                                    eval_every=WINDOWS, eval_data=test, scenario=scenario,
                                    scenario_key=jax.random.PRNGKey(200 + seed),
                                    scenario_kwargs=KNOBS[scenario])
            after = float(trace.metrics[task.metric_name][-1])
            print(f"{run} lr {cfg.lr} seed {seed}: {task.metric_name} {before:.4f} -> "
                  f"{after:.4f}, mean own-shard loss {loss0:.4f} -> "
                  f"{own_loss(state.params):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())

"""Cases and rank function of `tests/test_torch_distributed_algorithms.py`
(a helper, not a test module). The rank function runs in one process of
a gloo world spawned by `repro_torch.launch.mesh.spawn_ranks`, on the
CPU; this module imports no JAX, so a rank starts quickly.

A case is a dict: ``algo``, ``cfg``, ``steps`` (rounds, windows or tape
rows), and optionally ``states`` (initial solo states, one per seed, in
place of `KEYS`), ``draws`` (per seed, per step: the injected draws),
``tape`` (an `EventTape`, for the event family) and ``schedule`` (one
`Schedule`). `run_case` runs one through `simulate_sweep`, on a client
mesh or on one process, and returns what the test compares.
"""
import numpy as np

BASELINES = ("sync-symm", "sync-push", "async-symm", "async-push")
EVENTS = ("draco-event", "fedasync-gossip", "event-triggered")
ALGOS = BASELINES + ("fedasync-window",) + EVENTS
ROUNDS, WINDOWS, EVENT_ROWS = 8, 8, 40
KEYS = [7, 8]
EVAL_EVERY = 3  # off the unification period, whose evals read consensus 0


def _host(x):
    """A result field as the test compares it (a generator dropped)."""
    import torch

    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor) or isinstance(x, (np.ndarray, int, float, np.number)):
        return x
    return None


def run_case(case, inputs, mesh=None):
    """`case` through `simulate_sweep` on the `inputs` workload (``params0``,
    ``train``, ``test``), on `mesh` when given. Returns the finals' fields
    (leading (1, R) axes), the trace, and the reduce-scatters and
    broadcasts this rank ran."""
    from repro_torch.api import events_context, simulate_sweep
    from repro_torch.data.synthetic import mlp_fns

    _, loss, acc = mlp_fns(2)
    kw = dict(eval_every=EVAL_EVERY, eval_fn=acc, eval_data=inputs["test"], device="cpu",
              mesh=mesh)
    if case.get("tape") is not None:
        kw["ctx"] = events_context(case["cfg"], loss, inputs["train"],
                                   params0=inputs["params0"], tape=case["tape"], device="cpu")
    if case.get("states") is not None:
        kw["states"] = case["states"]
    else:
        kw["keys"] = KEYS
    if case.get("draws") is not None:
        draws = case["draws"]
        kw["draws_fn"] = lambda g, r, i: draws[r][i]
    if case.get("schedule") is not None:
        kw["schedules"] = [case["schedule"]]
    counts = dict(mesh.collective_counts) if mesh is not None else {}
    finals, trace = simulate_sweep(case["algo"], case["cfg"], inputs["params0"], loss,
                                   inputs["train"], case["steps"], **kw)
    out = {f: _host(getattr(finals, f)) for f in finals._fields}
    out.update(metrics=trace.metrics, step=trace.step)
    if mesh is not None:
        out["collectives"] = {k: mesh.collective_counts[k] - counts[k]
                              for k in ("reduce_scatter", "broadcast")}
    return out


def world(rank, world_size, blob):
    """Every case of `blob`, the pickled ``(cases {name: case}, inputs)``,
    on a client mesh of this world; then N = 9, which no world here
    divides, once per algorithm."""
    import pickle

    from repro_torch.api import simulate_sweep
    from repro_torch.launch import mesh as mesh_lib

    cases, inputs = pickle.loads(blob)

    mesh = mesh_lib.make_sweep_mesh(backend="gloo", device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "cases": {}, "indivisible": {}}
    for name, case in cases.items():
        out["cases"][name] = run_case(case, inputs, mesh)
    for algo in ALGOS:
        cfg = cases[algo]["cfg"].replace(num_clients=9)
        try:
            simulate_sweep(algo, cfg, task="mlp", num_steps=1, keys=[0], device="cpu",
                           mesh=mesh)
            out["indivisible"][algo] = "no error"
        except Exception as e:  # the test reads which error, and its message
            out["indivisible"][algo] = f"{type(e).__name__}: {e}"
    return out

"""Every registered algorithm on the port's client mesh: `simulate_sweep(
mesh=)` in gloo worlds of 2 and 4 ranks on the CPU, against the port's
unsharded sweep and against the JAX package.

Each world runs once (`_torch_dist_algos.world`, spawned by
`repro_torch.launch.mesh.spawn_ranks`; both worlds at once, while this
process runs the JAX package) and every case in it, at
`_torch_dist.sweep_setup()`'s size (N 8, a 6-8-3 MLP), the channel on
(and also off for the sync baselines, whose mix it makes the identity):

  - each of the 8 algorithms besides ``draco`` (which
    `tests/test_torch_distributed.py` holds) from its own seeds, against
    the port's unsharded sweep of the same case: the baselines at 8
    rounds, ``fedasync-window`` at 2 seeds x 8 windows, the event family
    at the first 40 rows of one tape. Params and every float field within
    2e-5, accuracies within 1e-5 (the bounds of the ``draco`` case), the
    counters (``total_accept``, ``tx_sent``, ``tx_count``,
    ``push_weight``, the accept counts) exact. Each rank ran one
    reduce-scatter per drain: per round, per batched window, per valid
    event;
  - ``sync-push``, ``async-symm``, ``fedasync-window`` and
    ``event-triggered`` from the reference's initial states and draws
    (`tests/_torch_draws.py`), against the JAX package's unsharded
    `simulate` / `simulate_sweep` within rtol = atol = 2e-5, counters
    exact;
  - ``async-push`` under a scenario `Schedule` with moving positions and
    compute rates, against the unsharded sweep;
  - N = 9 on 2 and 4 ranks raises `ValueError` for every algorithm, and
    none raises `NotImplementedError`.
"""
import concurrent.futures
import pickle

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

import _torch_dist_algos as A
from _torch_dist import SWEEP_N
from _torch_draws import draws_chain, event_draws_chain, round_draws_chain
from repro.api import get_algorithm as jget_algorithm
from repro.api import simulate as jsimulate
from repro.api import simulate_sweep as jsimulate_sweep
from repro.core import protocol as jp
from repro.core.channel import ChannelConfig as JChannel
from repro.data.synthetic import federated_classification, make_mlp
from repro.events import EventConfig as JEventConfig
from repro.events import events_context as jevents_context
from repro.events import init_event_state as jinit_event_state
from repro_torch import convert
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.protocol import DracoConfig
from repro_torch.events import KIND_TX, KIND_UNIFY, EventConfig, sample_event_tape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.scenarios import make_schedule

PER_CLIENT, HORIZON, TRIGGER = 32, 5.0, 0.05
TOL = dict(rtol=2e-5, atol=2e-5)
BASE = dict(num_clients=SWEEP_N, lr=0.1, local_batches=1, batch_size=8, lambda_grad=0.8,
            lambda_tx=0.8, unify_period=5, psi=2, topology="complete", max_delay_windows=3)
EVENT = dict(BASE, unify_period=2, staleness="poly", staleness_a=0.7, trigger_threshold=TRIGGER)
# fields compared exactly: the counters and the push weights
EXACT = ("accept_count", "total_accept", "tx_sent", "tx_count", "push_weight", "round_idx",
         "window_idx", "event_idx")
REFERENCE = ("sync-push", "async-symm", "fedasync-window", "event-triggered")
# with the channel on, each sync sender's own signal drowns every link (the
# channel's half-duplex model), so a sync round's mix is the identity: these
# also run with it off, and so does the reference's sync-push
SYNC_OFF = ("sync-symm", "sync-push")
UNSHARDED = A.ALGOS + tuple(f"{a} channel-off" for a in SYNC_OFF) + ("scenario async-push",)


def _cfgs(algo, channel=True):
    """(reference config, port config) of `algo`'s cases."""
    jchan, tchan = (JChannel(), ChannelConfig()) if channel else (None, None)
    if algo in A.BASELINES:
        return jp.DracoConfig(**BASE, channel=jchan), DracoConfig(**BASE, channel=tchan)
    return JEventConfig(**EVENT, channel=jchan), EventConfig(**EVENT, channel=tchan)


def _steps(algo):
    return A.ROUNDS if algo in A.BASELINES else A.WINDOWS if algo == "fedasync-window" \
        else A.EVENT_ROWS


@pytest.fixture(scope="module")
def workload():
    """The reference's data and MLP, and the port's copies of them."""
    k_data, k_model = jax.random.split(jax.random.PRNGKey(0))
    train, test = federated_classification(k_data, SWEEP_N, 6, 3, per_client=PER_CLIENT)
    params0, _, loss, acc = make_mlp(k_model, 6, (8,), 3)
    port = dict(params0=convert.params_from_numpy(params0, "cpu"),
                train=convert.data_from_numpy(train, "cpu"),
                test=convert.data_from_numpy(test, "cpu"))
    return dict(train=train, test=test, params0=params0, loss=loss, acc=acc), port


def _reference_case(algo, ref):
    """`algo` from the reference's initial state(s) and draws: the port's
    case and the reference's own unsharded run of it (a callable, so that
    it runs while the worlds do)."""
    jcfg, tcfg = _cfgs(algo, channel=algo not in SYNC_OFF)
    steps = _steps(algo)
    run = dict(eval_every=A.EVAL_EVERY, eval_fn=ref["acc"], eval_data=ref["test"])
    args = (ref["params0"], ref["loss"], ref["train"], steps)
    if algo == "fedasync-window":
        keys = jax.random.split(jax.random.PRNGKey(42), 2)
        inits = [jp.init_state(k, jcfg, ref["params0"]) for k in keys]
        case = dict(states=[convert.state_from_numpy(s, device="cpu") for s in inits],
                    draws=[[convert.draws_from_numpy(d, "cpu")
                            for d in draws_chain(s.key, jcfg, PER_CLIENT, steps)]
                           for s in inits])
        return dict(case, algo=algo, cfg=tcfg, steps=steps), \
            lambda: jsimulate_sweep(algo, jcfg, *args, keys=keys, **run)
    key = jax.random.PRNGKey(11)
    if algo == "event-triggered":
        jctx = jevents_context(jcfg, ref["loss"], ref["train"], params0=ref["params0"],
                               horizon=HORIZON, tape_seed=5)
        j0 = jinit_event_state(key, jcfg, ref["params0"])
        chain = event_draws_chain(j0.key, jcfg, PER_CLIENT, jctx.tape)[:steps]
        case = dict(states=[convert.event_state_from_numpy(j0, device="cpu")],
                    draws=[[None if d is None else convert.event_draws_from_numpy(d, "cpu")
                            for d in chain]],
                    tape=convert.tape_from_numpy(jctx.tape))
        return dict(case, algo=algo, cfg=tcfg, steps=steps), \
            lambda: jsimulate(algo, jcfg, *args, key=key, ctx=jctx, **run)
    init = jget_algorithm(algo).init(key, jcfg, ref["params0"])
    case = dict(states=[convert.baseline_state_from_numpy(init, device="cpu")],
                draws=[[convert.round_draws_from_numpy(d, "cpu")
                        for d in round_draws_chain(init.key, jcfg, algo, PER_CLIENT, steps)]])
    return dict(case, algo=algo, cfg=tcfg, steps=steps), \
        lambda: jsimulate(algo, jcfg, *args, key=key, **run)


def _cases(ref):
    """{name: case} of every world, and {name: the reference's run}."""
    cases, jruns = {}, {}
    for algo in A.ALGOS:
        _, tcfg = _cfgs(algo)
        cases[algo] = dict(algo=algo, cfg=tcfg, steps=_steps(algo))
        if algo in A.EVENTS:
            cases[algo]["tape"] = sample_event_tape(tcfg, HORIZON, seed=3)
    for algo in SYNC_OFF:
        cases[f"{algo} channel-off"] = dict(algo=algo, cfg=_cfgs(algo, channel=False)[1],
                                            steps=A.ROUNDS)
    for algo in REFERENCE:
        cases["reference " + algo], jruns[algo] = _reference_case(algo, ref)
    _, tcfg = _cfgs("async-push")
    waypoint = make_schedule("random-waypoint", tcfg, key=1, device="cpu")
    straggler = make_schedule("straggler-profile", tcfg, key=2, device="cpu")
    cases["scenario async-push"] = dict(
        algo="async-push", cfg=tcfg, steps=A.ROUNDS,
        schedule=waypoint._replace(compute_rate=straggler.compute_rate))
    return cases, jruns


@pytest.fixture(scope="module")
def runs(workload):
    """The worlds of 2 and 4 ranks (each in a thread that waits on its
    processes) while this process runs the reference; then the port's
    unsharded sweep of every case."""
    ref, port = workload
    cases, jruns = _cases(ref)

    # the cases' tensors go to the ranks pickled into bytes: as arguments,
    # each would travel as one shared-memory file descriptor
    blob = pickle.dumps((cases, port))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawned = {size: pool.submit(mesh_lib.spawn_ranks, A.world, size, blob,
                                     backend="gloo", timeout=120, deadline=300)
                   for size in (2, 4)}
        reference = {algo: run() for algo, run in jruns.items()}
        spawned = {size: w.result() for size, w in spawned.items()}
    plain = {name: A.run_case(case, port) for name, case in cases.items()}
    return dict(worlds=spawned, reference=reference, plain=plain, cases=cases)


def _fields(out):
    return [f for f, v in out.items() if f not in ("metrics", "step", "collectives")
            and v is not None]


def _assert_equal_runs(got, want, what):
    """A mesh run against the unsharded one: params and float fields within
    2e-5, the counters exact, accuracies within 1e-5."""
    assert _fields(got) == _fields(want), what
    for f in _fields(want):
        a, b = got[f], want[f]
        if isinstance(b, dict):
            for k in b:
                torch.testing.assert_close(a[k], b[k], **TOL, msg=f"{what}: {f}/{k}")
        elif f in EXACT or not (isinstance(b, torch.Tensor) and b.is_floating_point()):
            assert np.array_equal(np.asarray(a), np.asarray(b)), f"{what}: {f}"
        else:
            torch.testing.assert_close(a, b, **TOL, msg=f"{what}: {f}")
    np.testing.assert_array_equal(got["step"], want["step"])
    np.testing.assert_allclose(got["metrics"]["accuracy"], want["metrics"]["accuracy"],
                               atol=1e-5, err_msg=what)
    np.testing.assert_allclose(got["metrics"]["consensus"], want["metrics"]["consensus"],
                               rtol=1e-5, atol=1e-6, err_msg=what)


def _drains(case):
    """The drains of a case on each rank: one a round or a valid tape row
    of each seed (the baselines and the event family run their seeds one
    solo state after another), one a window of all seeds (the seed-stacked
    window)."""
    if case["algo"] == "fedasync-window":
        return case["steps"]
    seeds = len(case.get("states") or A.KEYS)
    if case["algo"] in A.BASELINES:
        return case["steps"] * seeds
    return seeds * int(case["tape"].valid[:case["steps"]].sum())


def _rows(case, kind):
    return int((case["tape"].kind[:case["steps"]] == kind).sum())


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", UNSHARDED)
def test_mesh_sweep_equals_unsharded(runs, size, name):
    case, want = runs["cases"][name], runs["plain"][name]
    outs = runs["worlds"][size]
    assert [o["rank"] for o in outs] == list(range(size))
    for o in outs:
        got = o["cases"][name]
        _assert_equal_runs(got, want, f"{name} on rank {o['rank']} of {size}")
        assert got["collectives"]["reduce_scatter"] == _drains(case), name
    if name in A.EVENTS:
        # a unification broadcasts the hub's row; event-triggered's TX row
        # broadcasts its fire decision
        unify, tx = _rows(case, KIND_UNIFY), _rows(case, KIND_TX)
        assert unify > 0 and tx > 0
        per_seed = unify + (tx if name == "event-triggered" else 0)
        assert outs[0]["cases"][name]["collectives"]["broadcast"] == len(A.KEYS) * per_seed
    if name == "event-triggered":  # suppression is observable, and some rows fire
        sent = want["tx_sent"].sum(dim=-1)
        assert bool((sent > 0).all()) and bool((sent < _rows(case, KIND_TX)).all())


def _as(got, ref):
    """`got` in the reference's shape; a seed-stacked row's one host
    window index stands for each of its seeds'."""
    got = np.asarray(got)
    if got.size != np.size(ref):
        got = np.broadcast_to(got.reshape(got.shape + (1,) * (np.ndim(ref) - got.ndim)),
                              np.shape(ref))
    return got.reshape(np.shape(ref))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("algo", REFERENCE)
def test_mesh_sweep_equals_reference(runs, size, algo):
    jfinal, jtrace = runs["reference"][algo]
    for o in runs["worlds"][size]:
        got = o["cases"]["reference " + algo]
        what = f"{algo} on rank {o['rank']} of {size}"
        for k, v in jfinal.params.items():
            np.testing.assert_allclose(_as(got["params"][k], v), np.asarray(v), **TOL,
                                       err_msg=what)
        for f in jfinal._fields:
            if f in ("params", "key") or got.get(f) is None:
                continue
            ref = np.asarray(getattr(jfinal, f))
            if f in EXACT or not np.issubdtype(ref.dtype, np.floating):
                np.testing.assert_array_equal(_as(got[f], ref), ref, err_msg=f"{what}: {f}")
            else:
                np.testing.assert_allclose(_as(got[f], ref), ref, **TOL, err_msg=f"{what}: {f}")
        np.testing.assert_array_equal(got["step"], np.asarray(jtrace.step))
        for k, v in jtrace.metrics.items():
            np.testing.assert_allclose(_as(got["metrics"][k], v), np.asarray(v), **TOL,
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("size", [2, 4])
def test_indivisible_clients_raise_and_nothing_is_unported(runs, size):
    for o in runs["worlds"][size]:
        for algo, err in o["indivisible"].items():
            assert err.startswith("ValueError") and "divisible" in err, (algo, err)
            assert "NotImplementedError" not in err

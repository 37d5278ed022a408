"""repro_torch.scenarios and the scenario path of every algorithm, against
the JAX package.

Each generator's numpy core is driven from the reference generator's own
initial state and numpy seed: adjacency rings exact, q and w_sym within
1e-6, positions within 1e-5, rate rings exact, and every ring passes
`validate_schedule`. Whole runs take the reference's `Schedule` through
`convert.schedule_from_numpy` and the reference's injected draws: a
20-window DRACO trace (small-cnn, momentum, straggler-profile) and a
20-round trace of each baseline under positions and compute rates within
1e-5, acceptances exact. ``scenario="static"`` equals the frozen-graph
path bit for bit.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_draws import draws_chain, round_draws_chain  # noqa: E402
from repro.api import get_algorithm as jget_algorithm  # noqa: E402
from repro.api import simulate as jsimulate  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.core.channel import ChannelConfig as JChannel  # noqa: E402
from repro.core.channel import place_nodes as jplace_nodes  # noqa: E402
from repro.core.topology import adjacency as jadjacency  # noqa: E402
from repro.scenarios import generators as jgen  # noqa: E402
from repro.scenarios import make_schedule as jmake_schedule  # noqa: E402
from repro.tasks import get_task as jget_task  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import get_algorithm, make_context, simulate  # noqa: E402
from repro_torch.core import flat as flat_lib  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.baselines import BASELINES  # noqa: E402
from repro_torch.core.channel import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core.topology import is_row_stochastic  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    Schedule,
    list_scenarios,
    make_schedule,
    validate_schedule,
)
from repro_torch.scenarios import generators as tgen  # noqa: E402
from repro_torch.tasks import get_task  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
EXACT_ISH = dict(rtol=1e-6, atol=1e-6)
N = 6


def _cfgs(n=N, topology="erdos", **over):
    kw = dict(num_clients=n, lr=0.05, window=0.03, lambda_grad=20.0, lambda_tx=20.0,
              psi=3, unify_period=7, batch_size=4, local_batches=1, topology=topology)
    kw.update(over)
    return (jp.DracoConfig(**kw, channel=JChannel()),
            tp.DracoConfig(**kw, channel=TChannel()))


def _assert_rings(port: Schedule, ref):
    """adj exact, q and w_sym within 1e-6, positions within 1e-5, rates exact."""
    validate_schedule(port)
    np.testing.assert_array_equal(port.adj.numpy(), np.asarray(ref.adj))
    np.testing.assert_allclose(port.q.numpy(), np.asarray(ref.q), **EXACT_ISH)
    np.testing.assert_allclose(port.w_sym.numpy(), np.asarray(ref.w_sym), **EXACT_ISH)
    for name in ("positions", "compute_rate", "tx_rate"):
        got, want = getattr(port, name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if want is not None:
            if name == "positions":
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_registry_names_the_reference_generators():
    from repro.scenarios import list_scenarios as jlist_scenarios

    assert list_scenarios() == jlist_scenarios() == (
        "markov-edge-flip", "random-waypoint", "static", "straggler-profile")


@pytest.mark.parametrize("topology", ["cycle", "erdos"])
def test_static_matches_reference(topology):
    jcfg, tcfg = _cfgs(topology=topology)
    key = jax.random.PRNGKey(3)
    ref = jgen.static(jcfg, key=key)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    _assert_rings(tgen.static(tcfg, key=seed, device="cpu"), ref)


@pytest.mark.parametrize("topology,churn,density", [
    ("erdos", 0.2, None), ("cycle", 0.5, None), ("complete", 0.3, 0.9)])
def test_markov_edge_flip_core_matches_reference(topology, churn, density):
    jcfg, _ = _cfgs(topology=topology)
    key = jax.random.PRNGKey(4)
    ref = jgen.markov_edge_flip(jcfg, key=key, steps=12, churn=churn, density=density)
    k_base, k_chain = jax.random.split(key)
    base = np.asarray(jadjacency(topology, N, key=k_base)).copy()
    adjs = tgen.markov_edge_flip_adjs(base, jgen._np_rng(k_chain), 12, churn, density)
    _assert_rings(tgen._rings_from_adjs(adjs, device="cpu"), ref)


@pytest.mark.parametrize("speed", [25.0, 180.0])
def test_random_waypoint_core_matches_reference(speed):
    jcfg, tcfg = _cfgs()
    key = jax.random.PRNGKey(5)
    ref = jgen.random_waypoint(jcfg, key=key, steps=16, speed=speed)
    k_pos, k_wp, k_next = jax.random.split(key, 3)
    chan = tcfg.channel
    traj, adjs, gains = tgen.random_waypoint_rings(
        np.asarray(jplace_nodes(k_pos, N, jcfg.channel)),
        np.asarray(jplace_nodes(k_wp, N, jcfg.channel)), jgen._np_rng(k_next), chan,
        16, speed)
    port = tgen._rings_from_adjs(adjs, gains, "cpu")._replace(
        positions=torch.as_tensor(traj))
    _assert_rings(port, ref)


@pytest.mark.parametrize("frac,duty", [(0.5, 0.5), (0.2, 1.0), (0.3, 0.25)])
def test_straggler_rates_core_matches_reference(frac, duty):
    jcfg, _ = _cfgs()
    key = jax.random.PRNGKey(6)
    ref = jgen.straggler_profile(jcfg, key=key, steps=10, straggler_frac=frac,
                                 slowdown=10.0, duty=duty)
    _, k_draw = jax.random.split(key)
    rate = tgen.straggler_rates(N, jgen._np_rng(k_draw), 10, frac, 10.0, duty)
    np.testing.assert_array_equal(rate, np.asarray(ref.compute_rate))
    assert (rate < 1).sum() > 0


@pytest.mark.parametrize("name,kw", [
    ("static", {}), ("markov-edge-flip", dict(churn=0.2)), ("random-waypoint", {}),
    ("straggler-profile", dict(straggler_frac=0.5, duty=0.5, modulate_tx=True))])
def test_port_generators_are_valid_and_seeded(name, kw):
    _, tcfg = _cfgs(n=9)
    a = make_schedule(name, tcfg, key=11, device="cpu", **kw)
    validate_schedule(a)
    assert a.num_clients == 9 and a.period == (1 if name == "static" else 32)
    b = make_schedule(name, tcfg, key=torch.Generator().manual_seed(11), device="cpu", **kw)
    validate_schedule(b)
    again = make_schedule(name, tcfg, key=11, device="cpu", **kw)
    for x, y in zip(a, again):
        assert (x is None and y is None) or torch.equal(x, y)
    snap = a.at(a.period + 3)
    assert torch.equal(snap.q, a.q[(a.period + 3) % a.q.shape[0]])
    assert snap.q.data_ptr() == a.q[(a.period + 3) % a.q.shape[0]].data_ptr()  # a view
    assert make_schedule(a, tcfg) is a
    with pytest.raises(ValueError):
        make_schedule(a, tcfg, churn=0.1)


def test_is_row_stochastic_matches_reference():
    from repro.core.topology import is_row_stochastic as jis_row_stochastic

    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.random((5, 5)).astype(np.float32) * (rng.random((5, 5)) < 0.6)
        np.fill_diagonal(q, rng.choice([0.0, 0.3]))
        q = q / np.maximum(q.sum(axis=1, keepdims=True), 1e-9) * rng.choice([1.0, 1.1])
        q = q.astype(np.float32)
        assert is_row_stochastic(torch.as_tensor(q)) == jis_row_stochastic(q)


@pytest.mark.parametrize("algo", ["draco", *BASELINES])
@pytest.mark.parametrize("topology", ["cycle", "erdos"])
def test_static_scenario_is_the_frozen_path_bit_for_bit(algo, topology):
    _, tcfg = _cfgs(topology=topology)
    task = get_task("mlp", hidden=(8,), per_client=32)
    kw = dict(task=task, num_steps=9, key=2, eval_every=3, graph_seed=7, device="cpu")
    s0, tr0 = simulate(algo, tcfg, **kw)
    s1, tr1 = simulate(algo, tcfg, scenario="static", **kw)
    for a, b in zip(flat_lib.tree_leaves(s0.params), flat_lib.tree_leaves(s1.params)):
        assert torch.equal(a, b)
    for k in tr0.metrics:
        np.testing.assert_array_equal(tr0.metrics[k], tr1.metrics[k])


def test_scenario_arguments_are_checked():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="without scenario"):
        make_context(tcfg, task="mlp", scenario_kwargs={"churn": 0.1}, device="cpu")
    ctx = make_context(tcfg, task="mlp", graph_seed=1, device="cpu")
    with pytest.raises(ValueError, match="make_context"):
        simulate("draco", tcfg, task="mlp", key=0, ctx=ctx, scenario="static",
                 device="cpu")
    other = make_schedule("static", tcfg.replace(num_clients=N + 1), key=1, device="cpu")
    with pytest.raises(ValueError, match="clients"):
        make_context(tcfg, task="mlp", scenario=other, device="cpu")
    ctx = make_context(tcfg, task=get_task("mlp", optimizer="adamw"), graph_seed=1,
                       scenario="markov-edge-flip", params0=get_task("mlp").init_params(
                           torch.Generator().manual_seed(0)), device="cpu")
    assert ctx.flat_spec.opt_dim == 2 * ctx.flat_spec.dim + 1
    assert torch.equal(ctx.q, ctx.schedule.q[0])


@pytest.mark.parametrize("scenario,kw", [
    ("static", {}), ("markov-edge-flip", dict(churn=0.2, steps=8)),
    ("random-waypoint", dict(steps=8)),
    ("straggler-profile", dict(straggler_frac=0.5, slowdown=10.0, duty=0.5, steps=8))])
@pytest.mark.parametrize("algo", ["draco", *BASELINES])
def test_simulate_runs_every_scenario_with_the_new_tasks(algo, scenario, kw):
    """The port's own draws: tiny-lm with AdamW and warmup-cosine for the
    DRACO windows, small-cnn with Nesterov momentum for the rounds."""
    _, tcfg = _cfgs(n=4)
    if algo == "draco":
        task = get_task("tiny-lm", vocab=16, d_model=8, d_ff=16, seq_len=8, per_client=16,
                        eval_size=8, optimizer="adamw", schedule="warmup-cosine",
                        schedule_kwargs={"warmup": 2, "total_steps": 6})
    else:
        task = get_task("small-cnn", per_client=16, optimizer="momentum",
                        opt_kwargs={"nesterov": True})
    state, trace = simulate(algo, tcfg, task=task, num_steps=6, key=1, eval_every=3,
                            scenario=scenario, scenario_key=3, scenario_kwargs=kw,
                            device="cpu")
    assert list(trace.step) == [3, 6]
    assert all(np.isfinite(v).all() for v in trace.metrics.values())
    assert state.opt_state.shape[1] > 0 and bool(torch.isfinite(state.opt_state).all())
    if scenario == "random-waypoint":
        sched = make_schedule(scenario, tcfg, key=3, device="cpu", **kw)
        assert torch.equal(state.positions, sched.positions[5])


def test_draco_trace_small_cnn_momentum_straggler_matches_reference():
    """20 windows of small-cnn with momentum under the reference's
    straggler-profile (frac 0.5, slowdown 10, duty 0.5, period 8; the tx
    rate modulated too), channel on, Psi = 3."""
    jt = jget_task("small-cnn", per_client=16, optimizer="momentum")
    tt = get_task("small-cnn", per_client=16, optimizer="momentum")
    jcfg, tcfg = _cfgs(n=4)
    k_model, k_data, k_state, k_sched = jax.random.split(jax.random.PRNGKey(9), 4)
    params0 = jt.init_params(k_model)
    train, test = jt.make_data(k_data, 4)
    sched = jmake_schedule("straggler-profile", jcfg, key=k_sched, steps=8,
                           straggler_frac=0.5, slowdown=10.0, duty=0.5, modulate_tx=True)
    init = jp.init_state(k_state, jcfg, params0, task=jt)
    windows = 20
    jstate, jtrace = jsimulate("draco", jcfg, params0, data=train, num_steps=windows,
                               task=jt, state=init, eval_every=10, eval_data=test,
                               scenario=sched)
    chain = draws_chain(init.key, jcfg, train[0].shape[1], windows, schedule=sched)
    tstate, ttrace = simulate(
        "draco", tcfg, convert.params_from_numpy(params0, "cpu"),
        data=convert.data_from_numpy(train, "cpu"), num_steps=windows, task=tt,
        state=convert.state_from_numpy(init, device="cpu"), eval_every=10,
        eval_data=convert.data_from_numpy(test, "cpu"),
        scenario=convert.schedule_from_numpy(sched, "cpu"), device="cpu",
        draws_fn=lambda w: convert.draws_from_numpy(chain[w], "cpu"))
    masks = np.stack([c["grad_mask"] for c in chain])
    assert masks.any() and not masks.all()
    np.testing.assert_array_equal(tstate.total_accept.numpy(), np.asarray(jstate.total_accept))
    for a, b in zip(flat_lib.tree_leaves(tstate.params), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tstate.opt_state.numpy(), np.asarray(jstate.opt_state), **TOL)
    for k in jtrace.metrics:
        np.testing.assert_allclose(ttrace.metrics[k], np.asarray(jtrace.metrics[k]), **TOL)


@pytest.mark.parametrize("method", BASELINES)
def test_baseline_trace_with_positions_and_rates_matches_reference(method):
    """20 rounds of mlp with momentum under a carried-across schedule that
    moves the nodes (random-waypoint, period 8) and scales participation
    (a straggler compute-rate ring, period 5), channel on."""
    n, rounds = 6, 20
    jt = jget_task("mlp", hidden=(8,), per_client=16, optimizer="momentum")
    tt = get_task("mlp", hidden=(8,), per_client=16, optimizer="momentum")
    jcfg, tcfg = _cfgs(n=n)
    k_model, k_data, k_state, k_a, k_b = jax.random.split(jax.random.PRNGKey(12), 5)
    params0 = jt.init_params(k_model)
    train, test = jt.make_data(k_data, n)
    moving = jmake_schedule("random-waypoint", jcfg, key=k_a, steps=8, speed=80.0)
    slow = jmake_schedule("straggler-profile", jcfg, key=k_b, steps=5,
                          straggler_frac=0.5, duty=0.6)
    sched = moving._replace(compute_rate=slow.compute_rate)
    init = jget_algorithm(method).init(k_state, jcfg, params0, task=jt)
    jstate, jtrace = jsimulate(method, jcfg, params0, data=train, num_steps=rounds, task=jt,
                               state=init, eval_every=10, eval_data=test, scenario=sched)
    chain = round_draws_chain(init.key, jcfg, method, train[0].shape[1], rounds,
                              schedule=sched)
    tstate, ttrace = simulate(
        method, tcfg, convert.params_from_numpy(params0, "cpu"),
        data=convert.data_from_numpy(train, "cpu"), num_steps=rounds, task=tt,
        state=convert.baseline_state_from_numpy(init, device="cpu"), eval_every=10,
        eval_data=convert.data_from_numpy(test, "cpu"),
        scenario=convert.schedule_from_numpy(sched, "cpu"), device="cpu",
        draws_fn=lambda r: convert.round_draws_from_numpy(chain[r], "cpu"))
    active = np.stack([c["active"] for c in chain])
    assert active.any() and not active.all()
    for a, b in zip(flat_lib.tree_leaves(tstate.params), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tstate.opt_state.numpy(), np.asarray(jstate.opt_state), **TOL)
    np.testing.assert_allclose(tstate.push_weight.numpy(), np.asarray(jstate.push_weight),
                               **TOL)
    np.testing.assert_allclose(tstate.positions.numpy(), np.asarray(jstate.positions), **TOL)
    for k in jtrace.metrics:
        np.testing.assert_allclose(ttrace.metrics[k], np.asarray(jtrace.metrics[k]), **TOL)
    assert get_algorithm(method).step_index(tstate) == rounds

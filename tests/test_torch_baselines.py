"""The port's four baselines (`repro_torch.core.baselines`, their
`repro_torch.api` adapters, `topology.metropolis`, `configs.draco_paper`)
against the JAX reference.

The reference's draws are rebuilt from its keys (`_torch_draws.round_draws`)
and injected, so both packages consume the same random outcomes. Masks and
the Metropolis weights must match exactly; rounds and 20-round `simulate`
traces within f32 rtol/atol 1e-5. One baseline round and one `draco`
window also run at N = 100, past the gossip kernels' narrow routes (on the
CPU both take their plain versions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from _torch_draws import draws_chain, round_draws, round_draws_chain  # noqa: E402
from repro.api import get_algorithm as jget_algorithm  # noqa: E402
from repro.api import list_algorithms as jlist_algorithms  # noqa: E402
from repro.api import simulate as jsimulate  # noqa: E402
from repro.api import steps_for_budget as jsteps_for_budget  # noqa: E402
from repro.configs import draco_paper as jpaper  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.channel import ChannelConfig as JChannel  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import get_algorithm, list_algorithms, simulate, steps_for_budget  # noqa: E402
from repro_torch.configs import draco_paper as tpaper  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.channel import ChannelConfig as TChannel  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ROUNDS = {"sync-symm": "w_sym", "sync-push": None, "async-symm": "w_sym",
          "async-push": None}


def _cfgs(n=6, channel=True, **over):
    kw = dict(num_clients=n, lr=0.1, batch_size=8, lambda_grad=0.3, lambda_tx=0.3,
              psi=0, unify_period=10, topology="cycle")
    kw.update(over)
    return (jp.DracoConfig(**kw, channel=JChannel() if channel else None),
            tp.DracoConfig(**kw, channel=TChannel() if channel else None))


def _workload(n, per_client=32, dim=16, classes=5, hidden=(32,), seed=0):
    k_data, k_model, k_sim = jax.random.split(jax.random.PRNGKey(seed), 3)
    train, test = jsyn.federated_classification(k_data, n, dim, classes,
                                                per_client=per_client)
    params0, _, loss, acc = jsyn.make_mlp(k_model, dim, hidden, classes)
    _, tloss, tacc = tsyn.mlp_fns(len(hidden) + 1)
    return train, test, params0, loss, acc, tloss, tacc, k_sim


def _assert_params(tparams, jparams, tol=TOL):
    for k in jparams:
        np.testing.assert_allclose(np.asarray(tparams[k]), np.asarray(jparams[k]), **tol)


# --- metropolis, configs -----------------------------------------------------

@pytest.mark.parametrize("topology,n", [
    (t, n) for t in ("cycle", "complete", "star", "erdos") for n in (6, 16, 25)]
    + [("ring2d", 9), ("ring2d", 16), ("ring2d", 25), ("cycle", 100)])
def test_metropolis_matches_reference_exactly(topology, n):
    """Every topology the reference builds, at the sizes the port's tests
    and the fig3 setup use; on the cycle also at N = 100."""
    key = jax.random.PRNGKey(7)
    jadj = jtopo.adjacency(topology, n, key=key) if topology == "erdos" \
        else jtopo.adjacency(topology, n)
    want = np.asarray(jtopo.metropolis(jadj))
    got = ttopo.metropolis(torch.as_tensor(np.array(jadj)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # symmetric and doubly stochastic
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)


def test_draco_paper_configs_match_reference():
    assert set(tpaper.TASKS) == set(jpaper.TASKS)
    for name, ref in jpaper.TASKS.items():
        got = tpaper.TASKS[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(ref)]
    assert tpaper.EMNIST == tpaper.TASKS["emnist"] and tpaper.POKER == tpaper.TASKS["poker"]


# --- one round ---------------------------------------------------------------

def _jround(method, jstate, jcfg, w_sym, adj, loss, train):
    if method == "sync-symm":
        return jb.sync_symm_round(jstate, jcfg, w_sym, adj, loss, train), None
    if method == "sync-push":
        return jb.sync_push_round(jstate, jcfg, adj, loss, train)
    if method == "async-symm":
        return jb.async_symm_round(jstate, jcfg, w_sym, adj, loss, train), None
    return jb.async_push_round(jstate, jcfg, adj, loss, train)


def _tround(method, state, tcfg, w_sym, adj, tloss, data, draws):
    fn = {"sync-symm": tb.sync_symm_round, "sync-push": tb.sync_push_round,
          "async-symm": tb.async_symm_round, "async-push": tb.async_push_round}[method]
    args = (state, tcfg, w_sym, adj, tloss, data) if ROUNDS[method] else \
        (state, tcfg, adj, tloss, data)
    out = fn(*args, draws=draws)
    return out if method.endswith("push") else (out, None)


@pytest.mark.parametrize("channel", [True, False])
@pytest.mark.parametrize("method", tb.BASELINES)
def test_round_matches_reference(method, channel):
    """Two rounds from the reference's initial state (the second from
    mixed, unequal params and push weights), each against the reference's
    round on its own key."""
    n, per_client = 7, 32
    jcfg, tcfg = _cfgs(n, channel)
    train, _, params0, loss, _, tloss, _, k_sim = _workload(n, per_client)
    jstate = jb.init_baseline_state(k_sim, jcfg, params0)
    jadj = jtopo.adjacency(jcfg.topology, n)
    jw = jtopo.metropolis(jadj)
    adj, w_sym = torch.as_tensor(np.array(jadj)), torch.as_tensor(np.array(jw))
    state = convert.baseline_state_from_numpy(jstate, device="cpu")
    data = convert.data_from_numpy(train, "cpu")
    for _ in range(2):
        raw, _ = round_draws(jstate.key, jcfg, method, per_client)
        draws = convert.round_draws_from_numpy(raw, "cpu")
        jstate, jview = _jround(method, jstate, jcfg, jw, jadj, loss, train)
        state, view = _tround(method, state, tcfg, w_sym, adj, tloss, data, draws)
        assert state.round_idx == int(jstate.round_idx)
        _assert_params(state.params, jstate.params)
        np.testing.assert_allclose(state.push_weight.numpy(),
                                   np.asarray(jstate.push_weight), **TOL)
        if jview is not None:
            _assert_params(view, jview)
    np.testing.assert_array_equal(state.positions.numpy(), np.asarray(jstate.positions))


@pytest.mark.parametrize("channel", [True, False])
@pytest.mark.parametrize("method", tb.BASELINES)
def test_masks_and_links_match_reference_exactly(method, channel):
    """The participation mask and the surviving links: no reduction runs,
    so they are equal, as are the push methods' mass splits (sums of 0/1
    links only)."""
    n, per_client = 9, 16
    jcfg, tcfg = _cfgs(n, channel, topology="complete")
    _, _, params0, _, _, _, _, k_sim = _workload(n, per_client)
    jstate = jb.init_baseline_state(k_sim, jcfg, params0)
    state = convert.baseline_state_from_numpy(jstate, device="cpu")
    jadj = jtopo.adjacency(jcfg.topology, n)
    adj = torch.as_tensor(np.array(jadj))
    for _ in range(3):
        raw, k_next = round_draws(jstate.key, jcfg, method, per_client)
        draws = convert.round_draws_from_numpy(raw, "cpu")
        if method.startswith("sync"):
            _, _, k_c = jax.random.split(jstate.key, 3)
            jactive = jnp.ones((n,), bool)
        else:
            _, k_a, _, k_c = jax.random.split(jstate.key, 4)
            jactive = jb._participation(k_a, n, 0.5, None)
        np.testing.assert_array_equal(draws.active.numpy(), np.asarray(jactive))
        jsucc = jb._link_success(k_c, jstate, jcfg, jadj, jactive)
        succ = tb._link_success(state, tcfg, adj, draws.active, draws.fading)
        np.testing.assert_array_equal(succ.numpy(), np.asarray(jsucc))
        if method == "sync-push":
            col = jsucc.astype(jnp.float32) + jnp.eye(n)
            want = col / col.sum(axis=1, keepdims=True)
            np.testing.assert_array_equal(tb.push_split(succ).numpy(), np.asarray(want))
        if method == "async-push":
            out = jsucc.astype(jnp.float32)
            outdeg = out.sum(axis=1, keepdims=True)
            send = jnp.where(outdeg > 0, 0.5 * out / jnp.maximum(outdeg, 1e-9), 0.0)
            want = send + jnp.diag(jnp.where(outdeg[:, 0] > 0, 0.5, 1.0))
            np.testing.assert_array_equal(tb.half_push_split(succ).numpy(), np.asarray(want))
        jstate = jstate._replace(key=k_next)
    # in a sync round with the channel on every receiver transmits too, and
    # its own signal drowns every link (the channel's half-duplex model)
    assert bool(succ.any()) != (channel and method.startswith("sync"))


# --- simulate ------------------------------------------------------------------

@pytest.mark.parametrize("method", tb.BASELINES)
def test_simulate_trace_matches_reference(method):
    """20 rounds at N = 8 with metrics every 6 (and the final row)."""
    n, per_client, rounds = 8, 32, 20
    jcfg, tcfg = _cfgs(n)
    train, test, params0, loss, acc, tloss, tacc, k_sim = _workload(n, per_client)
    jstate, jtrace = jsimulate(method, jcfg, params0, loss, train, rounds, key=k_sim,
                               eval_every=6, eval_fn=acc, eval_data=test)
    init = jget_algorithm(method).init(k_sim, jcfg, params0)
    chain = round_draws_chain(init.key, jcfg, method, per_client, rounds)
    tstate, ttrace = simulate(
        method, tcfg, convert.params_from_numpy(params0, "cpu"), tloss,
        convert.data_from_numpy(train, "cpu"), rounds,
        state=convert.baseline_state_from_numpy(init, device="cpu"), eval_every=6,
        eval_fn=tacc, eval_data=convert.data_from_numpy(test, "cpu"), device="cpu",
        draws_fn=lambda r: convert.round_draws_from_numpy(chain[r], "cpu"))
    assert list(ttrace.step) == list(np.asarray(jtrace.step)) == [6, 12, 18, 20]
    for k in jtrace.metrics:
        np.testing.assert_allclose(ttrace.metrics[k], np.asarray(jtrace.metrics[k]), **TOL)
    assert tstate.round_idx == int(jstate.round_idx) == rounds
    _assert_params(tstate.params, jstate.params)
    np.testing.assert_allclose(tstate.push_weight.numpy(), np.asarray(jstate.push_weight),
                               **TOL)
    _assert_params(get_algorithm(method).eval_params(tstate),
                   jget_algorithm(method).eval_params(jstate))


def test_baseline_round_at_n100_matches_reference():
    """Three sync-symm rounds at N = 100 (channel on): past the mix
    kernel's narrow route, the same mix on the CPU."""
    n, per_client = 100, 16
    jcfg, tcfg = _cfgs(n)
    train, test, params0, loss, acc, tloss, tacc, k_sim = _workload(
        n, per_client, dim=8, classes=4, hidden=(8,))
    jstate, jtrace = jsimulate("sync-symm", jcfg, params0, loss, train, 3, key=k_sim,
                               eval_every=3, eval_fn=acc, eval_data=test)
    init = jget_algorithm("sync-symm").init(k_sim, jcfg, params0)
    chain = round_draws_chain(init.key, jcfg, "sync-symm", per_client, 3)
    tstate, ttrace = simulate(
        "sync-symm", tcfg, convert.params_from_numpy(params0, "cpu"), tloss,
        convert.data_from_numpy(train, "cpu"), 3,
        state=convert.baseline_state_from_numpy(init, device="cpu"), eval_every=3,
        eval_fn=tacc, eval_data=convert.data_from_numpy(test, "cpu"), device="cpu",
        draws_fn=lambda r: convert.round_draws_from_numpy(chain[r], "cpu"))
    _assert_params(tstate.params, jstate.params)
    for k in jtrace.metrics:
        np.testing.assert_allclose(ttrace.metrics[k], np.asarray(jtrace.metrics[k]), **TOL)


def test_draco_window_at_n100_matches_reference():
    """Four draco windows at N = 100 (channel on, Psi cap): the drain past
    its narrow route, the plain version on the CPU."""
    n, per_client, windows = 100, 16, 4
    jcfg, tcfg = _cfgs(n, psi=3, lambda_grad=2.0, lambda_tx=2.0)
    train, _, params0, loss, _, tloss, _, k_sim = _workload(
        n, per_client, dim=8, classes=4, hidden=(8,))
    init = jp.init_state(k_sim, jcfg, params0)
    chain = draws_chain(init.key, jcfg, per_client, windows)
    jq, jadj = jp.build_graph(jcfg)
    jstate = init
    for _ in range(windows):
        jstate = jp.draco_window(jstate, jcfg, jq, jadj, loss, train)
    state = convert.state_from_numpy(init, device="cpu")
    q, adj = torch.as_tensor(np.array(jq)), torch.as_tensor(np.array(jadj))
    state = tp.run_windows(state, tcfg, q, adj, tloss, convert.data_from_numpy(train, "cpu"),
                           windows, draws_fn=lambda w: convert.draws_from_numpy(chain[w], "cpu"))
    assert int(jstate.total_accept.sum()) > 0
    np.testing.assert_array_equal(state.total_accept.numpy(), np.asarray(jstate.total_accept))
    _assert_params(state.params, jstate.params)
    np.testing.assert_allclose(state.buffer.numpy(), np.asarray(jstate.buffer), **TOL)


# --- registry, budgets, local step -------------------------------------------

def test_registry_names_the_reference_methods_but_the_event_family():
    """The registry names exactly the reference's methods; the event family
    registers when `repro_torch.api` imports `repro_torch.events`."""
    event_family = {"draco-event", "fedasync-gossip", "event-triggered", "fedasync-window"}
    assert set(list_algorithms()) == set(jlist_algorithms())
    assert set(list_algorithms()) == {"draco", *tb.BASELINES} | event_family


@pytest.mark.parametrize("task", [None, "mlp", "linear-softmax"])
@pytest.mark.parametrize("method", ["draco", *tb.BASELINES])
def test_steps_for_budget_and_grads_per_step_match_reference(method, task):
    jcfg, tcfg = _cfgs(lambda_grad=0.1, window=1.0)
    assert get_algorithm(method).grads_per_step(tcfg) == \
        jget_algorithm(method).grads_per_step(jcfg)
    budget = 300 * get_algorithm("draco").grads_per_step(tcfg)
    assert steps_for_budget(method, tcfg, budget, task=task) == \
        jsteps_for_budget(method, jcfg, budget, task=task)


def test_fig3_rounds_are_compute_matched():
    """300 DRACO windows at lambda 0.1 buy 29 sync rounds and 57 async ones."""
    _, tcfg = _cfgs(25, lambda_grad=0.1)
    budget = 300 * get_algorithm("draco").grads_per_step(tcfg)
    assert [steps_for_budget(m, tcfg, budget) for m in tb.BASELINES] == [29, 29, 57, 57]


def test_local_step_takes_plain_sgd_and_raises_for_other_optimizers():
    """A plain-SGD task's local step is the bare-loss SGD step bit for
    bit, with an empty optimizer plane; another optimizer (which raised
    before the optimizers were ported) now runs and moves its plane on
    the firing clients only."""
    from repro_torch.tasks import get_task

    _, tcfg = _cfgs(3, batch_size=4)
    task = get_task("mlp", input_dim=6, hidden=(4,), num_classes=3, per_client=8)
    g = torch.Generator().manual_seed(0)
    params0 = task.init_params(g)
    (xs, ys), _ = task.make_data(g, 3)
    params = {k: v.unsqueeze(0).repeat((3,) + (1,) * v.dim()) for k, v in params0.items()}
    idx = torch.randint(0, 8, (3, 1, 4), generator=g)
    mask = torch.tensor([True, False, True])
    empty = torch.zeros((3, 0))
    got, plane = tp.local_step(params, mask, tcfg, task, (xs, ys), idx, empty, 0)
    want = tp.local_updates(params, mask, tcfg, task.loss_fn, (xs, ys), idx)
    for k in want:
        assert torch.equal(got[k], want[k])
    assert not got["w0"][1].any() and plane is empty
    adamw = dataclasses.replace(task, opt_name="adamw")
    plane0 = torch.zeros((3, 2 * 43 + 1))
    got, plane = tp.local_step(params, mask, tcfg, adamw, (xs, ys), idx, plane0, 0)
    assert not got["w0"][1].any() and got["w0"][0].abs().sum() > 0
    assert torch.equal(plane[1], plane0[1]) and float(plane[0, 43]) == 1.0  # t ticked


def test_baseline_state_and_draws_carry_across():
    n = 5
    jcfg, tcfg = _cfgs(n)
    _, _, params0, *_, k_sim = _workload(n)
    jstate = jb.init_baseline_state(k_sim, jcfg, params0)
    state = convert.baseline_state_from_numpy(jstate, seed=3, device="cpu")
    assert state.round_idx == 0 and state.generator.initial_seed() == 3
    np.testing.assert_array_equal(state.push_weight.numpy(), np.ones(n, np.float32))
    _assert_params(state.params, jstate.params, dict(rtol=0, atol=0))
    raw, _ = round_draws(jstate.key, jcfg, "async-push", 32)
    draws = convert.round_draws_from_numpy(raw, "cpu")
    assert draws.active.dtype == torch.bool and draws.batch_idx.dtype == torch.int64
    assert tuple(draws.batch_idx.shape) == (n, 1, 8) and draws.fading.shape == (n, n)
    assert convert.round_draws_from_numpy(
        {k: v for k, v in raw.items() if k != "fading"}, "cpu").fading is None


@pytest.mark.parametrize("method", tb.BASELINES)
def test_simulate_baseline_on_cpu_learns(method):
    """The task spelling with the port's own draws: every method learns
    above chance and keeps finite push weights."""
    cfg = tp.DracoConfig(num_clients=6, lr=0.1, channel=TChannel())
    state, trace = simulate(method, cfg, task="linear-softmax", num_steps=40, key=0,
                            eval_every=20, device="cpu")
    assert list(trace.step) == [20, 40] and state.round_idx == 40
    assert trace.metrics["accuracy"][-1] > 0.4  # 5 classes: chance is 0.2
    assert bool(torch.isfinite(state.push_weight).all())
    assert bool((state.push_weight > 0).all())

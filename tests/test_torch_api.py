"""repro_torch simulate / tasks / data / layers against the JAX reference.

`simulate`'s trace (including the final row when num_steps is not a
multiple of eval_every) is held against the reference's with injected
draws at 1e-4 (a K-window trajectory); the model functions against the
reference's on the same params at 1e-5; the data builders draw from
Philox, so they are checked for layout and distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from _torch_draws import draws_chain
from repro.api import simulate as jsimulate
from repro.api import consensus_distance as jconsensus
from repro.api import steps_for_budget as jsteps_for_budget
from repro.core import protocol as jp
from repro.core.channel import ChannelConfig as JChannel
from repro.data import synthetic as jsyn
from repro.models import layers as jlayers
from repro.tasks import get_task as jget_task
from repro_torch import convert
from repro_torch.api import consensus_distance, simulate, steps_for_budget
from repro_torch.core import protocol as tp
from repro_torch.core.channel import ChannelConfig as TChannel
from repro_torch.data import synthetic as tsyn
from repro_torch.models import layers as tlayers
from repro_torch.tasks import get_task, list_tasks


def _cfgs(n=6, **over):
    kw = dict(num_clients=n, lr=0.1, window=0.03, lambda_grad=20.0,
              lambda_tx=20.0, psi=3, unify_period=3, batch_size=8)
    kw.update(over)
    return (jp.DracoConfig(**kw, channel=JChannel()),
            tp.DracoConfig(**kw, channel=TChannel()))


@pytest.mark.parametrize("num_steps,eval_every,rows", [(7, 3, [3, 6, 7]),
                                                       (6, 3, [3, 6]),
                                                       (2, 5, [2])])
def test_simulate_trace_matches_reference(num_steps, eval_every, rows):
    n, per_client = 6, 32
    jcfg, tcfg = _cfgs(n)
    k_data, k_model, k_sim = jax.random.split(jax.random.PRNGKey(0), 3)
    train, test = jsyn.federated_classification(k_data, n, 16, 5, per_client=per_client)
    params0, _, loss, acc = jsyn.make_mlp(k_model, 16, (32,), 5)
    jstate, jtrace = jsimulate("draco", jcfg, params0, loss, train, num_steps,
                               key=k_sim, eval_every=eval_every, eval_fn=acc,
                               eval_data=test)
    init = jp.init_state(k_sim, jcfg, params0)
    chain = draws_chain(init.key, jcfg, per_client, num_steps)
    _, tloss, tacc = tsyn.mlp_fns(2)
    tstate, ttrace = simulate(
        "draco", tcfg, convert.params_from_numpy(params0, "cpu"), tloss,
        convert.data_from_numpy(train, "cpu"), num_steps,
        state=convert.state_from_numpy(init, device="cpu"), eval_every=eval_every,
        eval_fn=tacc, eval_data=convert.data_from_numpy(test, "cpu"), device="cpu",
        draws_fn=lambda w: convert.draws_from_numpy(chain[w], "cpu"))
    assert ttrace.step.dtype == np.int32
    np.testing.assert_array_equal(ttrace.step, np.asarray(jtrace.step))
    assert list(ttrace.step) == rows
    assert set(ttrace.metrics) == set(jtrace.metrics) == {"accuracy", "consensus"}
    for k in ttrace.metrics:
        np.testing.assert_allclose(ttrace.metrics[k], np.asarray(jtrace.metrics[k]),
                                   rtol=1e-4, atol=1e-4)
    for k in params0:
        np.testing.assert_allclose(tstate.params[k].numpy(),
                                   np.asarray(jstate.params[k]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tstate.total_accept.numpy(),
                                  np.asarray(jstate.total_accept))


def test_simulate_without_eval_has_empty_trace():
    _, tcfg = _cfgs(4)
    state, trace = simulate("draco", tcfg, task="linear-softmax", num_steps=3,
                            key=1, device="cpu")
    assert trace.step.shape == (0,) and trace.step.dtype == np.int32
    assert trace.metrics == {} and state.window_idx == 3


def test_simulate_task_path_on_cpu_learns():
    """The task spelling builds params and data from `task_key`, runs, and
    samples the task metric; accuracy rises above chance."""
    cfg = tp.DracoConfig(num_clients=5, lambda_grad=1.0, lambda_tx=1.0, psi=2,
                         unify_period=10, channel=TChannel())
    state, trace = simulate("draco", cfg, task="linear-softmax", num_steps=40,
                            key=0, eval_every=15, device="cpu")
    assert list(trace.step) == [15, 30, 40]
    for v in trace.metrics.values():
        assert np.isfinite(v).all()
    assert trace.metrics["accuracy"][-1] > 0.4  # 5 classes: chance is 0.2
    assert int(state.total_accept.sum()) > 0


def test_simulate_rejects_conflicts():
    _, tcfg = _cfgs(4)
    with pytest.raises(ValueError):
        simulate("draco", tcfg, task="mlp", num_steps=1, device="cpu")  # no key
    with pytest.raises(ValueError):
        simulate("draco", tcfg, loss_fn=lambda *a: None, task="mlp", key=0,
                 device="cpu")
    with pytest.raises(KeyError):
        simulate("fedavg", tcfg, task="mlp", key=0, device="cpu")


def test_consensus_distance_matches_reference():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 4, 3)).astype(np.float32),
              "b": rng.standard_normal((5, 3)).astype(np.float32)}
    ref = float(jconsensus(jax.tree_util.tree_map(jnp.asarray, params)))
    got = float(consensus_distance(convert.params_from_numpy(params, "cpu")))
    assert got == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("task", [None, "mlp", "linear-softmax"])
def test_steps_for_budget_matches_reference(task):
    jcfg, tcfg = _cfgs(lambda_grad=0.3, window=1.0)
    assert steps_for_budget("draco", tcfg, 60.0, task=task) == \
        jsteps_for_budget("draco", jcfg, 60.0, task=task)


@pytest.mark.parametrize("name,kw", [
    ("mlp", {}), ("linear-softmax", {}),
    ("mlp", dict(input_dim=784, hidden=(160, 100), num_classes=47, per_client=1000))])
def test_task_grad_cost_and_metric_match_reference(name, kw):
    ref, got = jget_task(name, **kw), get_task(name, **kw)
    assert got.grad_cost == pytest.approx(ref.grad_cost, rel=1e-12)
    assert (got.metric_name, got.opt_name, got.schedule) == \
        (ref.metric_name, ref.opt_name, ref.schedule)


def test_task_registry():
    assert set(list_tasks()) == {"linear-softmax", "mlp", "small-cnn", "tiny-lm"}
    assert get_task("mlp", hidden=[8, 8]) is get_task("mlp", hidden=(8, 8))
    lm = get_task("tiny-lm")
    assert (lm.name, lm.metric_name, lm.opt_name) == ("tiny-lm", "perplexity", "sgd")
    assert get_task("mlp", optimizer="adamw") == get_task("mlp").with_optimizer("adamw")
    with pytest.raises(KeyError):
        get_task("resnet")


def test_task_builders_on_cpu():
    t = get_task("mlp", input_dim=12, hidden=(8,), num_classes=4, per_client=20)
    params0 = t.init_params(torch.Generator().manual_seed(0))
    assert [k for k in params0] == ["w0", "b0", "w1", "b1"]
    (xs, ys), (ex, ey) = t.make_data(torch.Generator().manual_seed(1), 3)
    assert xs.shape == (3, 20, 12) and ys.shape == (3, 20) and ex.shape == (2000, 12)
    stacked = {k: v.unsqueeze(0).repeat((3,) + (1,) * v.dim()) for k, v in params0.items()}
    assert t.loss_fn(stacked, xs, ys).shape == (3,)
    assert t.eval_fn(stacked, ex, ey).shape == (3,)


def test_mlp_functions_match_reference():
    n = 4
    params0, _, loss, acc = jsyn.make_mlp(jax.random.PRNGKey(3), 16, (32, 8), 5)
    rng = np.random.default_rng(0)
    stacked = {k: (np.asarray(v)[None] + 0.1 * rng.standard_normal((n,) + v.shape))
               .astype(np.float32) for k, v in params0.items()}
    x = rng.standard_normal((n, 10, 16)).astype(np.float32)
    y = rng.integers(0, 5, (n, 10))
    ex = rng.standard_normal((50, 16)).astype(np.float32)
    ey = rng.integers(0, 5, (50,))
    jst = jax.tree_util.tree_map(jnp.asarray, stacked)
    ref_loss = jax.vmap(loss)(jst, jnp.asarray(x), jnp.asarray(y))
    ref_acc = jax.vmap(lambda p: acc(p, jnp.asarray(ex), jnp.asarray(ey)))(jst)
    _, tloss, tacc = tsyn.mlp_fns(3)
    tst = convert.params_from_numpy(stacked, "cpu")
    np.testing.assert_allclose(tloss(tst, torch.as_tensor(x), torch.as_tensor(y)).numpy(),
                               np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    # the same count of hits; the mean itself may round differently
    np.testing.assert_allclose(
        tacc(tst, torch.as_tensor(ex), torch.as_tensor(ey)).numpy(), np.asarray(ref_acc),
        rtol=0, atol=1e-6)
    # one client's params (no client axis) give the reference's scalar
    one = {k: v[0] for k, v in tst.items()}
    assert float(tloss(one, torch.as_tensor(x[0]), torch.as_tensor(y[0]))) == \
        pytest.approx(float(ref_loss[0]), rel=1e-5)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 7))
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        ref = float(jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                          None if m is None else jnp.asarray(m)))
        got = float(tlayers.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                          None if m is None else torch.as_tensor(m)))
        assert got == pytest.approx(ref, rel=1e-5)


def test_dense_init_scale_and_device():
    w = tlayers.dense_init(torch.Generator().manual_seed(0), (400, 300))
    assert w.dtype == torch.float32 and w.shape == (400, 300)
    assert float(w.std()) == pytest.approx(1 / 20, rel=0.02)
    assert tlayers.dense_init(torch.Generator(), (3, 2), dtype=torch.bfloat16).dtype \
        == torch.bfloat16


def test_federated_classification_layout_and_skew():
    (xs, ys), (tx, ty) = tsyn.federated_classification(
        0, 6, input_dim=10, num_classes=8, per_client=300, test_size=400,
        alpha=0.1, device="cpu")
    assert xs.shape == (6, 300, 10) and xs.dtype == torch.float32
    assert ys.shape == (6, 300) and ys.dtype == torch.int64
    assert tx.shape == (400, 10) and ty.shape == (400,)
    assert 0 <= int(ys.min()) and int(ys.max()) < 8
    # Dirichlet(0.1) shards are non-iid: each client's top class dominates
    top = torch.stack([torch.bincount(ys[i], minlength=8).max() for i in range(6)])
    assert float(top.float().mean()) > 0.4 * 300


def test_classification_task_shares_anchors():
    x, y, anchors = tsyn.classification_task(0, 500, 6, 3, noise=0.1, device="cpu")
    assert anchors.shape == (3, 6)
    err = (x - anchors[y]).norm(dim=1)
    assert float(err.mean()) < 0.5
    x2, _, a2 = tsyn.classification_task(1, 10, 6, 3, anchors=anchors, device="cpu")
    assert a2 is anchors and x2.shape == (10, 6)


def test_dirichlet_partition_indices_in_range():
    y = torch.randint(0, 4, (100,), generator=torch.Generator().manual_seed(0))
    idx = tsyn.dirichlet_partition(torch.Generator().manual_seed(1), y, 5, 4,
                                   per_client=30)
    assert idx.shape == (5, 30) and idx.dtype == torch.int64
    assert 0 <= int(idx.min()) and int(idx.max()) < 100


def test_convert_sorts_keys_and_copies_state():
    params = {"w1": np.ones((2, 3), np.float32), "b0": np.zeros((2,), np.float32),
              "inner": {"z": np.ones((2, 1), np.float32), "a": np.ones((2, 1), np.float32)}}
    t = convert.params_from_numpy(params, "cpu")
    assert list(t) == ["b0", "inner", "w1"] and list(t["inner"]) == ["a", "z"]
    jcfg, _ = _cfgs(4, max_delay_windows=3)
    js = jp.init_state(jax.random.PRNGKey(0), jcfg, {"w": jnp.ones((2,))})
    ts = convert.state_from_numpy(js, device="cpu")
    assert ts.buffer.shape == (3, 4, 2) and ts.delay_ring.dtype == torch.int32
    np.testing.assert_array_equal(ts.positions.numpy(), np.asarray(js.positions))
    assert ts.window_idx == 0

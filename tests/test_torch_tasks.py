"""repro_torch's task zoo (small-cnn, tiny-lm) and the local optimizer
plane on the protocol path, against the JAX package.

Params, data and the reference's schedules are carried across with
`repro_torch.convert`; the reference's draws come from its own key ladder
(`_torch_draws`) and are injected. Tolerances (f32): loss, gradients and
metrics rtol = atol = 1e-5; one `task_local_updates` call (delta and the
(N, Dopt) optimizer plane) 1e-5, with the rows of clients outside the
grad mask bit-identical; a 20-window DRACO trace 1e-5 on params, the
optimizer plane and the metrics, acceptances exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from _torch_draws import _batch_rows, draws_chain  # noqa: E402
from repro.api import simulate as jsimulate  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.core.channel import ChannelConfig as JChannel  # noqa: E402
from repro.scenarios import make_schedule as jmake_schedule  # noqa: E402
from repro.tasks import get_task as jget_task  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import simulate  # noqa: E402
from repro_torch.core import flat as flat_lib  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.channel import ChannelConfig as TChannel  # noqa: E402
from repro_torch.tasks import get_task  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N = 4
LM = dict(vocab=16, d_model=8, num_heads=2, d_ff=16, seq_len=8, per_client=16,
          eval_size=8)
CNN = dict(per_client=16)


def _cfgs(**over):
    kw = dict(num_clients=N, lr=0.05, window=0.03, lambda_grad=20.0, lambda_tx=20.0,
              psi=3, unify_period=7, batch_size=4, local_batches=1)
    kw.update(over)
    return (jp.DracoConfig(**kw, channel=JChannel()),
            tp.DracoConfig(**kw, channel=TChannel()))


def _perturbed(params0, seed, scale=0.05):
    """N client copies of one client's params, each moved by its own noise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p)[None] + scale * rng.standard_normal((N,) + p.shape))
        .astype(np.float32), params0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _close_tree(got, want, tol=TOL):
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = flat_lib.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        _close(g.detach().numpy(), w, tol)


@pytest.mark.parametrize("name,kw", [("small-cnn", {}), ("tiny-lm", {}),
                                     ("tiny-lm", LM)])
def test_task_metadata_matches_reference(name, kw):
    ref, got = jget_task(name, **kw), get_task(name, **kw)
    assert got.grad_cost == pytest.approx(ref.grad_cost, rel=1e-12)
    assert (got.metric_name, got.opt_name, got.schedule) == \
        (ref.metric_name, ref.opt_name, ref.schedule)
    for args, kwargs in ((("momentum",), dict(beta=0.8)),
                         (("adamw", "cosine"), dict(schedule_kwargs={"total_steps": 9})),
                         (("sgd",), {})):
        r, g = ref.with_optimizer(*args, **kwargs), got.with_optimizer(*args, **kwargs)
        assert (g.opt_name, g.schedule, g.opt_kwargs, g.schedule_kwargs) == \
            (r.opt_name, r.schedule, r.opt_kwargs, r.schedule_kwargs)
    assert get_task(name, optimizer="adamw", **kw) == got.with_optimizer("adamw")


@pytest.mark.parametrize("name", ["small-cnn", "tiny-lm"])
def test_loss_grad_and_metric_match_reference(name):
    """Default widths: per-client losses and gradients of a batch, and
    the metric on the shared eval set, from the reference's params."""
    jt, tt = jget_task(name), get_task(name)
    params = _perturbed(jt.init_params(jax.random.PRNGKey(1)), 0)
    (xs, ys), (ex, ey) = jt.make_data(jax.random.PRNGKey(2), N)
    x, y = xs[:, :6], ys[:, :6]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jloss = jax.vmap(jt.loss_fn)(jparams, x, y)
    jgrad = jax.vmap(jax.grad(jt.loss_fn))(jparams, x, y)
    jmetric = jax.vmap(jt.eval_fn, (0, None, None))(jparams, ex, ey)

    tparams = convert.params_from_numpy(params, "cpu")
    tx, ty = convert.data_from_numpy((x, y), "cpu")
    tex, tey = convert.data_from_numpy((ex, ey), "cpu")
    leaves = [leaf.requires_grad_(True) for leaf in flat_lib.tree_leaves(tparams)]
    loss = tt.loss_fn(tparams, tx, ty)
    grads = torch.autograd.grad(loss.sum(), leaves)
    _close(loss.detach().numpy(), jloss)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrad)):
        _close(g.numpy(), w)
    with torch.no_grad():
        _close(tt.eval_fn(tparams, tex, tey).numpy(), jmetric)


def test_local_updates_gathers_targets_with_trailing_axes():
    """Plain SGD of a bare loss whose targets are (N, P, S) (tiny-lm's
    next tokens): the batch rows of both inputs and targets, and the
    Delta, as the reference gathers them per client."""
    jt, tt = jget_task("tiny-lm", **LM), get_task("tiny-lm", **LM)
    jcfg, tcfg = _cfgs(local_batches=2)
    params = _perturbed(jt.init_params(jax.random.PRNGKey(3)), 1)
    (xs, ys), _ = jt.make_data(jax.random.PRNGKey(4), N)
    assert ys.ndim == 3
    k_gsel = jax.random.PRNGKey(5)
    mask = np.array([True, True, False, True])
    rows = np.asarray(_batch_rows(k_gsel, jcfg, xs.shape[1]))
    ref = jp.local_updates(k_gsel, jax.tree_util.tree_map(jnp.asarray, params),
                           jnp.asarray(mask), jcfg, jt.loss_fn, (xs, ys))
    tdata = convert.data_from_numpy((xs, ys), "cpu")
    assert tdata[0].dtype == torch.int64
    idx = torch.as_tensor(rows.astype(np.int64))
    bx, by = tp._batch(*tdata, idx[:, 1])
    want_y = np.take_along_axis(np.asarray(ys), rows[:, 1][..., None], axis=1)
    np.testing.assert_array_equal(by.numpy(), want_y)
    np.testing.assert_array_equal(
        bx.numpy(), np.take_along_axis(np.asarray(xs), rows[:, 1][..., None], axis=1))
    got = tp.local_updates(convert.params_from_numpy(params, "cpu"), torch.as_tensor(mask),
                           tcfg, tt.loss_fn, tdata, idx)
    _close_tree(got, ref)
    assert not any(leaf[2].any() for leaf in flat_lib.tree_leaves(got))


CASES = {
    "tiny-lm-adamw": ("tiny-lm", LM, dict(optimizer="adamw", schedule="warmup-cosine",
                                          schedule_kwargs={"warmup": 2, "total_steps": 9},
                                          opt_kwargs={"weight_decay": 0.01})),
    "small-cnn-nesterov": ("small-cnn", CNN, dict(optimizer="momentum", schedule="cosine",
                                                  schedule_kwargs={"total_steps": 9},
                                                  opt_kwargs={"nesterov": True})),
    "mlp-sgd": ("mlp", dict(per_client=16), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_task_local_updates_match_reference(case):
    """Two calls of `task_local_updates` (B = 2): every client fires at
    step 0 from the zero plane, then three of four fire at step 3 from
    the reference's plane. Delta and plane within 1e-5; the idle
    client's Delta is zero and its plane row is kept bit for bit."""
    name, kw, opt = CASES[case]
    jt, tt = jget_task(name, **kw, **opt), get_task(name, **kw, **opt)
    jcfg, tcfg = _cfgs(local_batches=2)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    _perturbed(jt.init_params(jax.random.PRNGKey(6)), 2))
    (xs, ys), _ = jt.make_data(jax.random.PRNGKey(7), N)
    tdata = convert.data_from_numpy((xs, ys), "cpu")
    plane = jp._opt_plane(jt, jax.tree_util.tree_map(lambda p: p[0], params), N)
    tplane = torch.as_tensor(np.array(plane))
    for step, mask in ((0, np.ones(N, bool)), (3, np.array([True, False, True, True]))):
        key = jax.random.PRNGKey(10 + step)
        delta, plane_new = jp.task_local_updates(key, params, jnp.asarray(mask), jcfg, jt,
                                                 (xs, ys), plane, jnp.int32(step))
        idx = torch.as_tensor(np.asarray(_batch_rows(key, jcfg, xs.shape[1])))
        tdelta, tplane_new = tp.task_local_updates(
            convert.params_from_numpy(params, "cpu"), torch.as_tensor(mask), tcfg, tt,
            tdata, idx, tplane, step)
        _close_tree(tdelta, delta)
        _close(tplane_new.numpy(), plane_new)
        for i in np.flatnonzero(~mask):
            assert torch.equal(tplane_new[i], tplane[i])
            assert not any(leaf[i].any() for leaf in flat_lib.tree_leaves(tdelta))
        plane, tplane = plane_new, torch.as_tensor(np.array(plane_new))
    if opt.get("optimizer") == "adamw":
        dflat = flat_lib.spec_of(convert.params_from_numpy(params, "cpu")).dim
        np.testing.assert_array_equal(tplane[:, dflat].numpy(), [4.0, 2.0, 4.0, 4.0])


def test_draco_trace_tiny_lm_adamw_random_waypoint_matches_reference():
    """20 windows of tiny-lm with AdamW and warmup-cosine under the
    reference's random-waypoint schedule (period 8, so the rings wrap),
    channel on, Psi = 3, unification every 7 windows."""
    name, kw, opt = CASES["tiny-lm-adamw"]
    opt = dict(opt, schedule_kwargs={"warmup": 4, "total_steps": 20})
    jt, tt = jget_task(name, **kw, **opt), get_task(name, **kw, **opt)
    jcfg, tcfg = _cfgs()
    k_model, k_data, k_state, k_sched = jax.random.split(jax.random.PRNGKey(8), 4)
    params0 = jt.init_params(k_model)
    train, test = jt.make_data(k_data, N)
    sched = jmake_schedule("random-waypoint", jcfg, key=k_sched, steps=8)
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
    assert int(np.asarray(jstate.total_accept).sum()) > 0
    np.testing.assert_array_equal(tstate.total_accept.numpy(), np.asarray(jstate.total_accept))
    _close_tree(tstate.params, jstate.params)
    _close(tstate.opt_state.numpy(), jstate.opt_state)
    _close(tstate.positions.numpy(), jstate.positions)
    assert list(ttrace.step) == list(np.asarray(jtrace.step)) == [10, 20]
    for k in jtrace.metrics:
        _close(ttrace.metrics[k], jtrace.metrics[k])
    assert float(np.asarray(jstate.opt_state)[:, flat_lib.spec_of(tstate.params).dim].max()) > 1

"""repro_torch.optim (local optimizers, lr schedules) and the optimizer
plane's width and layout, against the JAX package.

Each optimizer x schedule runs several updates of one numpy-seeded
pytree on both sides: updates and states within rtol = atol = 1e-6 per
step. A client-stacked AdamW state raveled to its (N, Dopt) plane must
put every value in the reference's column (``[m | t | v]``), and
`opt_width` must equal the reference's exactly.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro import optim as joptim  # noqa: E402
from repro.optim.optimizers import apply_updates as japply_updates  # noqa: E402
from repro.tasks import get_task as jget_task  # noqa: E402
from repro.tasks import opt_width as jopt_width  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.core import flat as flat_lib  # noqa: E402
from repro_torch.tasks import get_task  # noqa: E402
from repro_torch.tasks.base import opt_width  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"w": (3, 4), "b": (4,), "blk": {"a": (2, 2), "z": (5,)}}
SCHEDULES = {
    "constant": (lambda lr: joptim.constant_schedule(lr),
                 lambda lr: optim.constant_schedule(lr)),
    "cosine": (lambda lr: joptim.cosine_schedule(lr, 9, 0.2),
               lambda lr: optim.cosine_schedule(lr, 9, 0.2)),
    "warmup-cosine": (lambda lr: joptim.warmup_cosine(lr, 3, 11),
                      lambda lr: optim.warmup_cosine(lr, 3, 11)),
}
OPTIMIZERS = {
    "sgd": (joptim.sgd, optim.sgd, {}),
    "momentum": (joptim.momentum, optim.momentum, dict(beta=0.8)),
    "nesterov": (joptim.momentum, optim.momentum, dict(beta=0.9, nesterov=True)),
    "adamw": (joptim.adamw, optim.adamw, dict(b1=0.85, b2=0.97, weight_decay=0.01)),
}


def _tree(rng, shapes, lead=()):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, lead) for k, v in shapes.items()}
    return rng.standard_normal(lead + shapes).astype(np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    got_items = flat_lib.tree_items(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_items) == len(want_leaves)
    for (_, g), w in zip(got_items, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_schedule_matches_reference(sched):
    jsched, tsched = (f(0.3) for f in SCHEDULES[sched])
    jfn = jax.jit(jsched)
    for step in range(16):
        got = tsched(step)
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(got, np.asarray(jfn(jnp.int32(step))), **TOL)


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_matches_reference(name, sched):
    jmake, tmake, kw = OPTIMIZERS[name]
    jsched, tsched = (f(0.05) for f in SCHEDULES[sched])
    jopt, topt = jmake(jsched, **kw), tmake(tsched, **kw)
    rng = np.random.default_rng(len(name) + len(sched))
    params = _tree(rng, SHAPES)
    jp, tp = _jtree(params), convert.params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for step in range(6):
        grads = _tree(rng, SHAPES)
        jupd, js = jupdate(_jtree(grads), js, jp, jnp.int32(step))
        tupd, ts = topt.update(convert.params_from_numpy(grads, "cpu"), ts, tp, step)
        _close(tupd, jupd)
        _close(ts, js)
        jp, tp = japply_updates(jp, jupd), optim.apply_updates(tp, tupd)
        _close(tp, jp)


def test_adamw_plane_layout_is_the_references():
    """Client-stacked AdamW state raveled to (N, Dopt) against each
    client's `ravel_pytree` of the reference state (``[m | t | v]``).
    Client i takes i + 1 updates, so each row has its own ``t``."""
    n = 3
    jopt = joptim.adamw(0.01, b1=0.9, b2=0.95)
    topt = optim.adamw(0.01, b1=0.9, b2=0.95)
    params = _tree(np.random.default_rng(7), SHAPES, (n,))

    def grads(i, step):
        return _tree(np.random.default_rng(100 * i + step), SHAPES)

    rows = []
    for i in range(n):
        jp = _jtree(jax.tree_util.tree_map(lambda x: x[i], params))
        js = jopt.init(jp)
        for step in range(i + 1):
            _, js = jopt.update(_jtree(grads(i, step)), js, jp, step)
        rows.append(np.asarray(jax.flatten_util.ravel_pytree(js)[0]))
    tp = convert.params_from_numpy(params, "cpu")
    ts = dict(topt.init(tp), t=torch.zeros((n,)))
    for step in range(n):
        g = _stack([grads(i, step) for i in range(n)])
        _, new = topt.update(convert.params_from_numpy(g, "cpu"), ts, tp, step)
        fires = torch.arange(n) >= step
        ts = flat_lib.tree_map(
            lambda a, b: torch.where(fires.reshape((n,) + (1,) * (a.dim() - 1)), a, b),
            new, ts)
    plane = flat_lib.ravel_clients(ts)
    dflat = flat_lib.spec_of(tp).dim
    assert tuple(plane.shape) == (n, 2 * dflat + 1) == np.stack(rows).shape
    np.testing.assert_array_equal(plane[:, dflat].numpy(),
                                  np.arange(1, n + 1, dtype=np.float32))
    np.testing.assert_allclose(plane.numpy(), np.stack(rows), **TOL)


def _stack(trees):
    """Per-client trees -> one client-stacked tree."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


@pytest.mark.parametrize("task,kw", [
    ("mlp", {}), ("linear-softmax", {}), ("small-cnn", {}),
    ("tiny-lm", dict(vocab=16, d_model=8, d_ff=16, seq_len=8))])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_opt_width_matches_reference(task, kw, opt):
    jt, tt = jget_task(task, optimizer=opt, **kw), get_task(task, optimizer=opt, **kw)
    params0 = jt.init_params(jax.random.PRNGKey(0))
    want = jopt_width(jt, params0)
    got = opt_width(tt, convert.params_from_numpy(params0, "cpu"))
    assert got == want
    dflat = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params0))
    assert want == {"sgd": 0, "momentum": dflat, "adamw": 2 * dflat + 1}[opt]
    assert opt_width(None, params0) == 0 and opt_width(tt.loss_fn, params0) == 0

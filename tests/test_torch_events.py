"""repro_torch's event machinery against the JAX package: the exact
timeline (`event_list`, `unify_hub`), the truncation bound and the
truncated Poisson counts, the event tape and its sizing rule, profiled
tapes, the staleness families and `EventConfig`.

Tolerances: the host-numpy pieces are copies of the reference's and are
held exactly (the same numpy seed gives the same events, the same tape
arrays, the same capacities); the staleness vectors exactly in f32. The
counts draw from Philox, so they are held to the reference's bound and
its statistics.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.core import events as jev
from repro.events import EventConfig as JEventConfig
from repro.events import staleness as jstale
from repro.events import tape as jtape
from repro.scenarios.base import Schedule as JSchedule
from repro_torch import convert
from repro_torch.core import events as tev
from repro_torch.core.protocol import DracoConfig, _unify
from repro_torch.events import EventConfig, staleness as tstale, tape as ttape

N = 5


def _events_equal(a, b):
    assert [(e.t, e.client, e.kind) for e in a] == [(e.t, e.client, e.kind) for e in b]


@pytest.mark.parametrize("kw", [
    dict(n=10, horizon=500.0, lam_grad=0.1, lam_tx=0.2, unify_period=50.0),
    dict(n=3, horizon=200.0, lam_grad=[0.5, 0.05, 0.0], lam_tx=0.0),
    dict(n=7, horizon=100.0, lam_grad=0.0, lam_tx=0.0, unify_period=5.0, random_hub=True),
])
def test_event_list_matches_reference_exactly(kw):
    ref = jev.event_list(np.random.default_rng(4), **kw)
    got = tev.event_list(np.random.default_rng(4), **kw)
    _events_equal(got, ref)
    assert [e.t for e in got] == sorted(e.t for e in got)


def test_unify_hub_matches_reference_and_the_window_engine():
    """The timeline's hubs follow the window engine's rotating rule (its
    `_unify` at the end of window k*P - 1), wrap-around included."""
    n, P = 4, 3
    assert [tev.unify_hub(k, n) for k in range(1, 12)] == \
        [jev.unify_hub(k, n) for k in range(1, 12)]
    evs = tev.event_list(np.random.default_rng(0), n=n, horizon=10 * P + 0.5,
                         lam_grad=0.1, lam_tx=0.1, unify_period=float(P))
    hubs = [e.client for e in evs if e.kind == "unify"]
    assert hubs[:5] == [0, 1, 2, 3, 0] and len(hubs) == 10
    cfg = DracoConfig(num_clients=n, unify_period=P)
    for k in range(1, 11):
        params = {"w": torch.arange(n, dtype=torch.float32)[:, None] + 100 * k}
        out, cnt = _unify(params, torch.ones((n,), dtype=torch.int32), k * P - 1, cfg, n)
        assert torch.equal(out["w"], out["w"][:1].expand_as(out["w"]))
        assert int(out["w"][0, 0]) - 100 * k == hubs[k - 1]
        assert int(cnt.sum()) == 0


@pytest.mark.parametrize("lamw", [0.0, 0.5, 2.0, 20.0, 50.0, 1e4])
def test_truncation_bound_matches_reference(lamw):
    assert tev.poisson_truncation_bound(lamw) == jev.poisson_truncation_bound(lamw)
    assert tev.poisson_truncation_bound(lamw, sigmas=3.0) == \
        jev.poisson_truncation_bound(lamw, sigmas=3.0)


def test_sample_event_counts_high_rate_unbiased():
    """The default cap is the rate's own bound, so a high-rate client's
    mean is unbiased; an explicit max_count clips as the reference does."""
    lam, w, n = 20.0, 1.0, 256
    g = torch.Generator().manual_seed(0)
    new = torch.stack([tev.sample_event_counts(g, lam, w, n) for _ in range(40)]).double()
    old = torch.stack([tev.sample_event_counts(g, lam, w, n, max_count=8)
                       for _ in range(40)]).double()
    assert new.dtype == torch.float64 and new.shape == (40, n)
    assert abs(float(new.mean()) - lam * w) < 4 * np.sqrt(lam * w / new.numel())
    assert float(new.max()) <= jev.poisson_truncation_bound(lam * w)
    assert float(old.max()) == 8.0 and abs(float(old.mean()) - 8.0) < 0.05
    # per-client rates: a zero rate never fires, the cap follows the peak
    lam_v = torch.tensor([0.0, 1.0, 30.0])
    c = tev.sample_event_counts(g, lam_v, 1.0, 3)
    assert c.dtype == torch.int64 and int(c[0]) == 0
    assert int(c[2]) <= jev.poisson_truncation_bound(30.0)


def _cfg(**kw):
    base = dict(num_clients=N, lambda_grad=0.4, lambda_tx=0.4, unify_period=8)
    base.update(kw)
    return JEventConfig(**base), EventConfig(**base)


def _tapes_equal(got, ref):
    for f in ("t", "client", "kind", "valid"):
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("horizon,seed", [(20.0, 0), (57.5, 3), (300.0, 1)])
def test_sample_event_tape_matches_reference_exactly(horizon, seed):
    jcfg, tcfg = _cfg()
    ref = jtape.sample_event_tape(jcfg, horizon, seed=seed)
    got = ttape.sample_event_tape(tcfg, horizon, seed=seed)
    _tapes_equal(got, ref)
    assert got.capacity == ref.capacity == ttape.tape_capacity(tcfg, horizon)
    assert got.num_valid == ref.num_valid and got.counts() == ref.counts()
    _tapes_equal(convert.tape_from_numpy(ref), ref)


def test_tape_from_events_pads_and_refuses_overflow():
    evs = tev.event_list(np.random.default_rng(0), N, 20.0, 0.4, 0.4)
    _tapes_equal(ttape.tape_from_events(evs, capacity=len(evs) + 7),
                 jtape.tape_from_events(evs, capacity=len(evs) + 7))
    with pytest.raises(ValueError, match="exceed tape capacity"):
        ttape.tape_from_events(evs, capacity=3)


def _schedules():
    """A straggler ring (rates 0 in some windows, one client always off)
    and a boosted one, in both packages."""
    rate = np.ones((4, N), np.float32)
    rate[:, 0] = 0.0
    rate[:2, 1] = 0.0
    eye = np.eye(N, dtype=np.float32)[None]
    ref = JSchedule(q=jnp.asarray(eye), adj=jnp.asarray(eye > 0), w_sym=jnp.asarray(eye),
                    compute_rate=jnp.asarray(rate), tx_rate=jnp.asarray(3.0 * rate[::-1]))
    return ref, convert.schedule_from_numpy(ref, "cpu")


def test_profiled_tape_and_capacity_match_reference():
    """Thinning against the rate rings: the same numpy draws, the same
    events and the same peak-rate capacity; an off client fires nothing
    and a duty-cycled one only in its on-windows."""
    jcfg, tcfg = _cfg(unify_period=0)
    jsched, tsched = _schedules()
    assert ttape.tape_capacity(tcfg, 100.0, schedule=tsched) == \
        jtape.tape_capacity(jcfg, 100.0, schedule=jsched)
    got = ttape.sample_event_tape(tcfg, 200.0, seed=5, schedule=tsched)
    _tapes_equal(got, jtape.sample_event_tape(jcfg, 200.0, seed=5, schedule=jsched))
    _events_equal(ttape.profiled_event_list(np.random.default_rng(2), tcfg, 50.0, tsched),
                  jtape.profiled_event_list(np.random.default_rng(2), jcfg, 50.0, jsched))
    grads = got.kind[got.valid] == ttape.KIND_GRAD
    cl, tt = got.client[got.valid][grads], got.t[got.valid][grads]
    assert (cl != 0).all() and (cl == 1).sum() > 0
    assert ((np.floor(tt[cl == 1] / tcfg.window).astype(int) % 4) >= 2).all()


@pytest.mark.parametrize("mode,a,b", [("constant", 0.5, 4.0), ("hinge", 0.5, 4.0),
                                      ("hinge", 1.7, 0.0), ("poly", 0.5, 4.0),
                                      ("poly", 0.7, 4.0), ("poly", 2.0, 4.0)])
def test_staleness_scale_matches_reference_exactly(mode, a, b):
    dtau = np.array([0.0, 0.25, 1.0, 3.0, 4.0, 4.000001, 4.5, 8.0, 57.3, 100.0], np.float32)
    ref = np.asarray(jstale.staleness_scale(mode, jnp.asarray(dtau), a, b))
    got = tstale.staleness_scale(mode, torch.as_tensor(dtau), a, b)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_staleness_families_and_vectors():
    s = tstale.staleness_scale
    hinge = s("hinge", [1.0, 4.0, 8.0], a=0.5, b=4.0).numpy()
    np.testing.assert_allclose(hinge, [1.0, 1.0, 1.0 / 3.0], rtol=1e-6)
    np.testing.assert_allclose(s("poly", [0.0, 3.0], a=0.5).numpy(), [1.0, 0.5], rtol=1e-6)
    with pytest.raises(ValueError):
        s("exp", 1.0)
    for kw in (dict(staleness="poly", staleness_a=0.5, max_delay_windows=4),
               dict(staleness="hinge", staleness_a=0.9, staleness_b=1.0)):
        jcfg, tcfg = _cfg(**kw)
        vec = tstale.staleness_damping_vector(tcfg)
        assert vec.shape == (tcfg.max_delay_windows,) and vec.dtype == torch.float32
        np.testing.assert_array_equal(vec.numpy(),
                                      np.asarray(jstale.staleness_damping_vector(jcfg)))
    assert tstale.staleness_damping_vector(_cfg()[1]) is None
    assert tstale.staleness_fn(_cfg()[1]) is None


def test_event_config_validation_matches_reference():
    for bad in (dict(staleness="exp"), dict(trigger_threshold=-1.0), dict(staleness_b=-1.0),
                dict(staleness_a=0.0)):
        with pytest.raises(ValueError) as ref_err:
            JEventConfig(**bad)
        with pytest.raises(ValueError) as got_err:
            EventConfig(**bad)
        assert str(got_err.value) == str(ref_err.value)
    assert EventConfig().replace(staleness="poly").staleness == "poly"
    assert isinstance(EventConfig(), DracoConfig)

"""repro_torch's continuous-time event engine against its own replay and
against the JAX package's engine.

The load-bearing assertions:
  - the port's engine (`repro_torch.events.engine`) equals the port's
    eager replay (`repro_torch.events.replay`) bit for bit, for each of
    the three tape-walking algorithms, with the channel on and off (on
    the CPU the engine's drain is the plain loop, so both sum in send
    order);
  - the port's engine, fed the reference's draws (its 4-way key split,
    tests/_torch_draws.py::event_draws), its tape and its initial state,
    equals the JAX package's `simulate_events` within f32 rtol = atol =
    1e-5 with every counter exact.
Everything else (padding, delivery timing, unification, suppression,
staleness, the windowed hybrid, sweeps) mirrors tests/test_event_engine.py
at its small size.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_draws import event_draws_chain
from repro.core.channel import ChannelConfig as JChannel
from repro.events import EventConfig as JEventConfig
from repro.events import events_context as jevents_context
from repro.events import init_event_state as jinit_event_state
from repro.events import simulate_events as jsimulate_events
from repro.tasks import get_task as jget_task
from repro_torch import convert
from repro_torch.api import get_algorithm, simulate, simulate_sweep, steps_for_budget
from repro_torch.core.channel import ChannelConfig
from repro_torch.events import (
    KIND_GRAD,
    KIND_TX,
    KIND_UNIFY,
    EventConfig,
    EventTape,
    events_context,
    init_event_state,
    replay_events,
    simulate_events,
)
from repro_torch.events.staleness import staleness_fn
from repro_torch.tasks import get_task

N = 5
HORIZON = 20.0
TASK = get_task("linear-softmax")
_G = torch.Generator().manual_seed(0)
PARAMS0 = TASK.init_params(_G)
DATA, EVAL = TASK.make_data(_G, N)


def _cfg(**kw):
    base = dict(num_clients=N, lr=0.05, local_batches=1, batch_size=8,
                lambda_grad=0.4, lambda_tx=0.4, unify_period=8, psi=2,
                topology="cycle", max_delay_windows=3, channel=None)
    base.update(kw)
    return EventConfig(**base)


def _ctx(cfg, horizon=HORIZON, tape_seed=3, **kw):
    return events_context(cfg, TASK, DATA, params0=PARAMS0, horizon=horizon,
                          tape_seed=tape_seed, device="cpu", **kw)


def _knobs(algo, cfg):
    damping = staleness_fn(cfg) if algo == "fedasync-gossip" else None
    trigger = float(cfg.trigger_threshold) if algo == "event-triggered" else 0.0
    return damping, trigger


def _equal(a, b, what):
    assert torch.equal(a, b), what


def _assert_state_equals_replay(st, rp):
    for field in ("pending", "opt_state", "accept_count", "total_accept", "tx_sent"):
        _equal(getattr(st, field), getattr(rp, field), field)
    for k in st.params:
        _equal(st.params[k], rp.params[k], k)
    assert st.tx_count == rp.tx_count


CHANNEL = ChannelConfig(gamma_max=3.0)
ALGOS = {"draco-event": {}, "fedasync-gossip": dict(staleness="poly", staleness_a=0.7),
         "event-triggered": dict(trigger_threshold=0.05)}


@pytest.mark.parametrize("channel", [False, True], ids=["channel-off", "channel-on"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_engine_matches_replay_bitwise(algo, channel):
    cfg = _cfg(channel=CHANNEL if channel else None, **ALGOS[algo])
    ctx = _ctx(cfg)
    st, _ = simulate_events(algo, cfg, ctx=ctx, key=7, device="cpu")
    damping, trigger = _knobs(algo, cfg)
    rp = replay_events(init_event_state(7, cfg, PARAMS0, task=TASK, device="cpu"), ctx,
                       damping=damping, trigger=trigger)
    _assert_state_equals_replay(st, rp)
    assert st.event_idx == ctx.tape.capacity and st.tx_count > 0
    if algo == "event-triggered":  # suppression is observable
        assert int(st.tx_sent.sum()) < ctx.tape.counts()["tx"]


# --- against the JAX package ------------------------------------------------

_JTASK = jget_task("linear-softmax")
_JKP, _JKD = jax.random.split(jax.random.PRNGKey(0))
_JPARAMS0 = _JTASK.init_params(_JKP)
_JDATA, _JEVAL = _JTASK.make_data(_JKD, N)


def _jcfg(channel, **kw):
    base = dict(num_clients=N, lr=0.05, local_batches=1, batch_size=8,
                lambda_grad=0.4, lambda_tx=0.4, unify_period=8, psi=2,
                topology="cycle", max_delay_windows=3,
                channel=JChannel(gamma_max=3.0) if channel else None)
    base.update(kw)
    return JEventConfig(**base), EventConfig(**dict(base, channel=CHANNEL if channel else None))


@pytest.mark.parametrize("channel", [False, True], ids=["channel-off", "channel-on"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_engine_matches_reference_with_injected_draws(algo, channel):
    jcfg, tcfg = _jcfg(channel, **ALGOS[algo])
    jctx = jevents_context(jcfg, _JTASK, _JDATA, params0=_JPARAMS0, horizon=HORIZON,
                           tape_seed=5)
    key = jax.random.PRNGKey(7)
    jst, jtrace = jsimulate_events(algo, jcfg, ctx=jctx, key=key, eval_every=30,
                                   eval_data=_JEVAL)
    j0 = jinit_event_state(key, jcfg, _JPARAMS0, task=_JTASK)
    chain = event_draws_chain(j0.key, jcfg, _JDATA[0].shape[1], jctx.tape)
    ctx = events_context(tcfg, TASK, convert.data_from_numpy(_JDATA, "cpu"),
                         params0=convert.params_from_numpy(_JPARAMS0, "cpu"),
                         tape=convert.tape_from_numpy(jctx.tape), device="cpu")
    assert ctx.tape.capacity == jctx.tape.capacity
    st, trace = simulate_events(
        algo, tcfg, ctx=ctx, state=convert.event_state_from_numpy(j0, device="cpu"),
        eval_every=30, eval_data=convert.data_from_numpy(_JEVAL, "cpu"), device="cpu",
        draws_fn=lambda e: None if chain[e] is None
        else convert.event_draws_from_numpy(chain[e], "cpu"))
    for k in st.params:
        np.testing.assert_allclose(st.params[k].numpy(), np.asarray(jst.params[k]),
                                   rtol=1e-5, atol=1e-5)
    for field in ("pending", "buffer", "w_ring", "deadline_ring", "send_time", "opt_state"):
        np.testing.assert_allclose(getattr(st, field).numpy(),
                                   np.asarray(getattr(jst, field)).reshape(
                                       getattr(st, field).shape), rtol=1e-5, atol=1e-5)
    for field in ("accept_count", "total_accept", "tx_sent"):
        np.testing.assert_array_equal(getattr(st, field).numpy(), np.asarray(getattr(jst, field)))
    assert (st.tx_count, st.event_idx) == (int(jst.tx_count), int(jst.event_idx))
    assert st.time == np.float32(jst.time)
    np.testing.assert_array_equal(trace.step, np.asarray(jtrace.step))
    for k in trace.metrics:
        np.testing.assert_allclose(trace.metrics[k], np.asarray(jtrace.metrics[k]),
                                   rtol=1e-5, atol=1e-5)


# --- event semantics --------------------------------------------------------


def _manual_tape(rows, capacity=None):
    t, client, kind = zip(*rows)
    cap = capacity or len(rows)
    pad = cap - len(rows)
    return EventTape(np.concatenate([t, [t[-1]] * pad]).astype(np.float32),
                     np.concatenate([client, [0] * pad]).astype(np.int32),
                     np.concatenate([kind, [0] * pad]).astype(np.int32),
                     np.asarray([True] * len(rows) + [False] * pad))


def test_padded_tape_is_noop_suffix():
    """Padding rows draw nothing and change nothing but the cursor."""
    cfg = _cfg()
    ctx = _ctx(cfg)
    st_a, _ = simulate_events("draco-event", cfg, ctx=ctx, key=9, device="cpu")
    tp = ctx.tape
    wide = EventTape(np.concatenate([tp.t, tp.t[-8:]]), np.concatenate([tp.client, tp.client[-8:]]),
                     np.concatenate([tp.kind, tp.kind[-8:]]),
                     np.concatenate([tp.valid, np.zeros((8,), bool)]))
    st_b, _ = simulate_events("draco-event", cfg, ctx=ctx, tape=wide, key=9, device="cpu")
    assert st_b.event_idx == st_a.event_idx + 8
    for k in st_a.params:
        _equal(st_a.params[k], st_b.params[k], k)
    assert torch.equal(st_a.generator.get_state(), st_b.generator.get_state())
    assert st_a.time == st_b.time


def test_delivery_waits_for_next_event():
    """Channel off: a broadcast lands at the next strictly later event."""
    cfg = _cfg(unify_period=0, psi=0, topology="complete")
    ctx = _ctx(cfg, tape_seed=0)
    rows = [(1.0, 0, KIND_GRAD), (2.0, 0, KIND_TX), (3.0, 1, KIND_GRAD)]
    st0 = init_event_state(1, cfg, PARAMS0, task=TASK, device="cpu")
    p0 = next(iter(st0.params.values()))
    st2, _ = simulate_events("draco-event", cfg, ctx=ctx._replace(tape=_manual_tape(rows[:2])),
                             key=1, device="cpu")
    receivers_2 = next(iter(st2.params.values()))[1:]
    assert torch.equal(receivers_2, p0[1:])  # nothing delivered yet...
    st3, _ = simulate_events("draco-event", cfg, ctx=ctx._replace(tape=_manual_tape(rows)),
                             key=1, device="cpu")
    assert not torch.equal(next(iter(st3.params.values()))[1:], p0[1:])  # ...now it is
    # the sender never applies its own update (paper semantics)
    assert torch.equal(next(iter(st2.params.values()))[0], p0[0])


def test_unify_event_adopts_hub_and_resets_psi():
    cfg = _cfg(unify_period=8, psi=1, topology="complete")
    hub = 3
    tape = _manual_tape([(1.0, 0, KIND_GRAD), (2.0, 0, KIND_TX), (3.0, 1, KIND_GRAD),
                         (8.0, hub, KIND_UNIFY)])
    st, _ = simulate_events("draco-event", cfg, ctx=_ctx(cfg)._replace(tape=tape), key=2,
                            device="cpu")
    for leaf in st.params.values():
        assert torch.equal(leaf, leaf[hub].expand_as(leaf))
    assert int(st.accept_count.abs().sum()) == 0
    assert int(st.total_accept.sum()) > 0


@pytest.mark.parametrize("algo,kw", [("event-triggered", dict(trigger_threshold=0.0)),
                                     ("fedasync-gossip", dict(staleness="constant"))])
def test_neutral_knob_is_draco_event_bitwise(algo, kw):
    cfg = _cfg(**kw)
    ctx = _ctx(cfg)
    st_a, _ = simulate_events("draco-event", cfg, ctx=ctx, key=4, device="cpu")
    st_b, _ = simulate_events(algo, cfg, ctx=ctx, key=4, device="cpu")
    for k in st_a.params:
        _equal(st_a.params[k], st_b.params[k], k)


def test_simulate_events_builds_its_own_context():
    """horizon= + tape_seed= build the task's data and the tape; the
    trace counts tape rows."""
    cfg = _cfg(lambda_grad=1.0, lambda_tx=1.0)
    st, trace = simulate_events("draco-event", cfg, task="linear-softmax", horizon=10.0,
                                tape_seed=1, key=0, eval_every=40, device="cpu")
    assert list(trace.step)[:2] == [40, 80] and trace.step[-1] == st.event_idx
    assert np.isfinite(trace.metrics["accuracy"]).all()
    with pytest.raises(ValueError, match="horizon"):
        simulate_events("draco-event", cfg, task="linear-softmax", key=0, device="cpu")


# --- the windowed hybrid, sweeps, pricing -------------------------------------


def test_fedasync_window_constant_is_draco_bitwise():
    cfg = _cfg(staleness="constant")
    st_a, _ = simulate("draco", cfg, task=TASK, data=DATA, params0=PARAMS0, num_steps=40,
                       key=3, device="cpu")
    st_b, _ = simulate("fedasync-window", cfg, task=TASK, data=DATA, params0=PARAMS0,
                       num_steps=40, key=3, device="cpu")
    for k in st_a.params:
        _equal(st_a.params[k], st_b.params[k], k)


def test_fedasync_window_damps_arrivals():
    """A poly family shrinks what arrives against undamped DRACO: the
    same events and sends, other mixing weights."""
    cfg = _cfg(staleness="poly", staleness_a=2.0, unify_period=0, topology="complete")
    runs = [simulate(a, cfg, task=TASK, data=DATA, params0=PARAMS0, num_steps=40, key=3,
                     device="cpu")[0] for a in ("draco", "fedasync-window")]
    moved = [sum(float((st.params[k] - PARAMS0[k]).abs().sum()) for k in PARAMS0)
             for st in runs]
    assert moved[0] != moved[1]
    assert torch.equal(runs[0].total_accept, runs[1].total_accept)


def test_event_family_sweeps_in_one_call():
    """lr x psi grids through `simulate_sweep` over a tape-carrying ctx;
    row (g, r) equals the solo run bit for bit."""
    cfg = _cfg(trigger_threshold=0.05, staleness="poly")
    ctx = _ctx(cfg)
    grid = [cfg, cfg.replace(lr=0.1), cfg.replace(psi=4)]
    for algo in ("draco-event", "fedasync-gossip", "event-triggered"):
        finals, _ = simulate_sweep(algo, grid, ctx=ctx, keys=[11, 12], task=TASK,
                                   num_steps=ctx.tape.capacity, device="cpu")
        for g in (1, 2):
            solo, _ = simulate_events(algo, grid[g], ctx=ctx._replace(cfg=grid[g]), key=12,
                                      device="cpu")
            for k in solo.params:
                _equal(finals.params[k][g, 1], solo.params[k], (algo, g, k))
            assert finals.tx_count[g, 1] == solo.tx_count


def test_lambda_sweep_is_rejected_for_event_algos():
    """The Poisson rates are baked into the sampled tape."""
    cfg = _cfg()
    ctx = _ctx(cfg)
    with pytest.raises(ValueError, match="does not consume"):
        simulate_sweep("draco-event", [cfg, cfg.replace(lambda_tx=0.8)], ctx=ctx, task=TASK,
                       key=0, num_seeds=1, num_steps=ctx.tape.capacity, device="cpu")


def test_grads_per_step_and_budget():
    cfg = _cfg(lambda_grad=0.3, lambda_tx=0.1)
    r = get_algorithm("draco-event").grads_per_step(cfg)
    np.testing.assert_allclose(r, 0.3 / (N * 0.4), rtol=1e-6)
    assert steps_for_budget("draco-event", cfg, 10.0) == round(10.0 / r)


def test_event_algorithms_require_a_tape():
    cfg = _cfg()
    with pytest.raises(ValueError, match="EventTape"):
        simulate("draco-event", cfg, task=TASK, data=DATA, params0=PARAMS0, num_steps=1,
                 key=0, device="cpu")

"""repro_torch's legacy (pre-fusion) window engine: against the JAX legacy
engine, and against the port's fused window (the counterpart of
tests/test_protocol_parity.py, at N = 5 and the MLP 6-8-3).

The reference's draws come from its own key ladder (`_torch_draws`); the
legacy window splits its key exactly as the fused one does
(`protocol.py:573-574` against `:420-421`, the same sample sites), so one
draws record drives both engines. State crosses with
`convert.legacy_state_from_numpy`, which carries the node positions drawn
at init. Tolerances:

  - port legacy against JAX legacy: f32 rtol = atol = 1e-5 on params,
    pending and the ring, counters exact, window by window;
  - port legacy against port fused (`draco_window` with the plain drain)
    on the same draws: bit for bit, as the reference's parity suite holds
    its two engines, also with two live delay buckets. The legacy engine
    adds D-1 separate contractions into its ring at enqueue time, while
    the fused drain's plain version (`gossip_drain_ref`) sums every bucket
    and sender in one einsum; at these sizes a receiver takes few messages
    a window and both orders give the same f32 sums.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_draws import draws_chain  # noqa: E402
from _torch_entry import single_thread  # noqa: E402,F401  (autouse: one CPU thread)
from repro.core import protocol as jp  # noqa: E402
from repro.core.channel import ChannelConfig as JChannel  # noqa: E402
from repro.data.synthetic import federated_classification, make_mlp  # noqa: E402
from repro.tasks import get_task as jget_task  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import flat as flat_lib  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.channel import ChannelConfig as TChannel  # noqa: E402
from repro_torch.data.synthetic import mlp_fns  # noqa: E402
from repro_torch.kernels.gossip import ops as gossip_ops  # noqa: E402
from repro_torch.tasks import get_task  # noqa: E402

N, PER_CLIENT = 5, 64
TOL = dict(rtol=1e-5, atol=1e-5)
CHANNEL = dict(message_bytes=51_640, gamma_max=10.0)


@pytest.fixture(scope="module")
def mlp():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    train, _ = federated_classification(k1, N, input_dim=6, num_classes=3,
                                        per_client=PER_CLIENT)
    params0, _, loss, _ = make_mlp(k2, 6, (8,), 3)
    _, tloss, _ = mlp_fns(2)
    return train, params0, loss, convert.data_from_numpy(train, "cpu"), tloss


def _cfgs(channel=True, **kw):
    base = dict(num_clients=N, lr=0.1, local_batches=1, batch_size=8, lambda_grad=0.8,
                lambda_tx=0.8, unify_period=10, psi=2, topology="complete",
                max_delay_windows=3)
    base.update(kw)
    return (jp.DracoConfig(**base, channel=JChannel(**CHANNEL) if channel else None),
            tp.DracoConfig(**base, channel=TChannel(**CHANNEL) if channel else None))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _assert_matches_reference(ts, js):
    for name, leaf in ts.params.items():
        _close(leaf, js.params[name])
    for name, leaf in ts.pending.items():
        _close(leaf, js.pending[name])
    for name, leaf in ts.buffer.items():
        _close(leaf, js.buffer[name])
    np.testing.assert_array_equal(ts.accept_count.numpy(), np.asarray(js.accept_count))
    np.testing.assert_array_equal(ts.total_accept.numpy(), np.asarray(js.total_accept))
    assert ts.window_idx == int(js.window_idx)


def _run_against_reference(jcfg, tcfg, key, windows, params0, jwork, twork, train,
                           tdata, every_window=True, jdraws=None):
    """`windows` legacy windows on both sides from one reference init, the
    reference's draws injected into the port; compared after each window
    (or only at the end). Returns the two final states."""
    js = jp.init_state_legacy(key, jcfg, params0, task=jwork if hasattr(jwork, "loss_fn")
                              else None)
    ts = convert.legacy_state_from_numpy(js, device="cpu")
    _close(ts.positions, js.positions)
    chain = jdraws or draws_chain(js.key, jcfg, train[0].shape[1], windows)
    q, adj = jp.build_graph(jcfg)
    tq, tadj = tp.build_graph(tcfg, device="cpu")
    step = jax.jit(lambda s: jp.draco_window_legacy(s, jcfg, q, adj, jwork, train))
    for w in range(windows):
        js = step(js)
        ts = tp.draco_window_legacy(ts, tcfg, tq, tadj, twork, tdata,
                                    draws=convert.draws_from_numpy(chain[w], "cpu"))
        if every_window or w == windows - 1:
            _assert_matches_reference(ts, js)
    return ts, js


@pytest.mark.parametrize("D", [2, 3, 4, 8])
def test_legacy_matches_reference_across_ring_depths_wireless(mlp, D):
    """Window by window with the channel: per-link delays of 1..D-1
    windows fill several buckets, longer ones are dropped."""
    train, params0, loss, tdata, tloss = mlp
    jcfg, tcfg = _cfgs(max_delay_windows=D)
    ts, js = _run_against_reference(jcfg, tcfg, jax.random.PRNGKey(D), 2 * D + 5, params0,
                                    loss, tloss, train, tdata)
    assert int(np.asarray(js.total_accept).sum()) > 0


def test_legacy_matches_reference_without_channel(mlp):
    """Every message has delay 1: one live bucket of the D - 1."""
    train, params0, loss, tdata, tloss = mlp
    jcfg, tcfg = _cfgs(channel=False, max_delay_windows=8, psi=0)
    _run_against_reference(jcfg, tcfg, jax.random.PRNGKey(1), 15, params0, loss, tloss,
                           train, tdata, every_window=False)


def test_legacy_matches_reference_through_unification_and_psi(mlp):
    """The Psi cap (psi 1, so the permutation decides), its periodic
    accept-count reset and hub unification stay in lockstep."""
    train, params0, loss, tdata, tloss = mlp
    jcfg, tcfg = _cfgs(unify_period=4, psi=1, lambda_tx=2.0, max_delay_windows=4)
    ts, js = _run_against_reference(jcfg, tcfg, jax.random.PRNGKey(2), 13, params0, loss,
                                    tloss, train, tdata)
    assert int(np.asarray(js.total_accept).sum()) > 0


def test_legacy_matches_reference_apply_self_update(mlp):
    train, params0, loss, tdata, tloss = mlp
    jcfg, tcfg = _cfgs(apply_self_update=True, max_delay_windows=4)
    _run_against_reference(jcfg, tcfg, jax.random.PRNGKey(3), 9, params0, loss, tloss,
                           train, tdata, every_window=False)


def test_legacy_matches_reference_with_momentum_task():
    """A `Task` with a momentum optimizer: the (N, Dopt) plane rides the
    legacy state as in the fused one."""
    kw = dict(input_dim=6, hidden=(8,), num_classes=3, per_client=PER_CLIENT)
    jt = jget_task("mlp", optimizer="momentum", **kw)
    tt = get_task("mlp", optimizer="momentum", **kw)
    k_model, k_data, k_state = jax.random.split(jax.random.PRNGKey(6), 3)
    params0 = jt.init_params(k_model)
    train, _ = jt.make_data(k_data, N)
    jcfg, tcfg = _cfgs(max_delay_windows=4, unify_period=5)
    ts, js = _run_against_reference(jcfg, tcfg, k_state, 8, params0, jt, tt, train,
                                    convert.data_from_numpy(train, "cpu"))
    assert ts.opt_state.shape == np.asarray(js.opt_state).shape
    assert float(np.abs(np.asarray(js.opt_state)).max()) > 0
    _close(ts.opt_state, js.opt_state)


def _outage_draws(cfg, num_samples, fading, tx_mask):
    """Every client fires a gradient event; `fading` (N, N) and `tx_mask`
    (N,) given."""
    g = torch.Generator().manual_seed(0)
    return tp.WindowDraws(
        grad_mask=torch.ones(N, dtype=torch.bool),
        batch_idx=torch.randint(0, num_samples, (N, 1, cfg.batch_size), generator=g),
        tx_mask=tx_mask, fading=fading)


@pytest.mark.parametrize("case", ["inf", "beyond-ring"])
def test_outage_link_is_dropped_not_delivered(mlp, case):
    """A link whose raw delay is inf, or finite past D - 1 windows, is
    dropped: its int cast must not wrap into a one-window delay (XLA
    saturates the cast, torch wraps it, so the port compares in float).

    ``inf``: a 1e-30 s window puts every link past int32, and a zero
    fading makes its link's delay (bits / 1e-9 b/s) / 1e-30 s = inf: no
    message is accepted and the ring stays empty. ``beyond-ring``: at a
    1 s window (senders 0 and 2 only, so little interference) a weak
    fading stretches their links to 1 and 3 past D - 1 windows while the
    others stay deliverable: each receiver accepts exactly its
    deliverable senders (Psi unbounded). Either way the reference's
    saturating cast of the same delays marks the same links deliverable."""
    _, params0, _, tdata, tloss = mlp
    window = 1e-30 if case == "inf" else 1.0
    D = 8
    _, tcfg = _cfgs(window=window, psi=0, unify_period=0, max_delay_windows=D)
    fading = np.ones((N, N), np.float32)
    fading[0, 1] = fading[2, 3] = 0.0 if case == "inf" else 1e-9
    tx_mask = torch.ones(N, dtype=torch.bool)
    if case == "beyond-ring":
        tx_mask = torch.tensor([True, False, True, False, False])
    draws = _outage_draws(tcfg, PER_CLIENT, torch.as_tensor(fading), tx_mask)
    ts = tp.init_state_legacy(0, tcfg, convert.params_from_numpy(params0, "cpu"),
                              device="cpu")
    gamma, success = tp.channel_lib.transmission_delays(draws.fading, ts.positions,
                                                        draws.tx_mask, tcfg.channel)
    raw = torch.ceil(gamma / window)
    if case == "inf":
        assert torch.isinf(raw[0, 1]) and torch.isinf(raw[2, 3])
        assert bool((raw > 2 ** 31).all())
    else:
        assert torch.isfinite(raw[0, 1]) and torch.isfinite(raw[2, 3])
        assert float(raw[0, 1]) > D - 1 and float(raw[2, 3]) > D - 1
    tq, tadj = tp.build_graph(tcfg, device="cpu")
    deliverable = (raw <= D - 1) & success & tadj
    # the reference's cast saturates: the same links are deliverable there
    jraw = jax.numpy.ceil(jax.numpy.asarray(gamma.numpy()) / window).astype(jax.numpy.int32)
    np.testing.assert_array_equal(np.asarray(jraw <= D - 1) & (success & tadj).numpy(),
                                  deliverable.numpy())

    nxt = tp.draco_window_legacy(ts, tcfg, tq, tadj, tloss, tdata, draws=draws)
    np.testing.assert_array_equal(nxt.total_accept.numpy(),
                                  deliverable.sum(dim=0).to(torch.int32).numpy())
    assert not bool(deliverable[0, 1]) and not bool(deliverable[2, 3])
    if case == "inf":
        assert int(nxt.total_accept.sum()) == 0
        assert all(not b.any() for b in nxt.buffer.values())
    else:
        assert int(nxt.total_accept.sum()) > 0
        assert any(b.any() for b in nxt.buffer.values())


def _fused_and_legacy(tcfg, seed, windows, params0, twork, tdata, task=None):
    """Both port engines from one seed (so the same node positions) on one
    draws record per window, the fused window through the plain drain."""
    fused = tp.init_state(seed, tcfg, params0, task=task, device="cpu")
    legacy = tp.init_state_legacy(seed, tcfg, params0, task=task, device="cpu")
    assert torch.equal(fused.positions, legacy.positions)
    tq, tadj = tp.build_graph(tcfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for _ in range(windows):
        draws = tp.sample_window_draws(g, tcfg, tdata[0].shape[1])
        fused = tp.draco_window(fused, tcfg, tq, tadj, twork, tdata, draws=draws,
                                drain=gossip_ops.gossip_drain_reference)
        legacy = tp.draco_window_legacy(legacy, tcfg, tq, tadj, twork, tdata, draws=draws)
    return fused, legacy


@pytest.mark.parametrize("D,channel,window", [(2, True, 1.0), (4, True, 1.0),
                                              (8, True, 0.01), (4, False, 1.0)])
def test_fused_matches_legacy_on_shared_draws(mlp, D, channel, window):
    """The port's two engines on one draws record, bit for bit: params,
    the fused pending against the raveled per-leaf pending, counters. At
    a 10 ms window with lambda 20 the delays fill two buckets at once."""
    _, params0, _, tdata, tloss = mlp
    rate = 20.0 if window < 1 else 0.8
    _, tcfg = _cfgs(channel=channel, max_delay_windows=D, unify_period=6, window=window,
                    lambda_grad=rate, lambda_tx=2.0 if channel and window == 1 else rate,
                    psi=0 if window < 1 else 2)
    tparams0 = convert.params_from_numpy(params0, "cpu")
    fused, legacy = _fused_and_legacy(tcfg, D, 2 * D + 5, tparams0, tloss, tdata)
    assert int(legacy.total_accept.sum()) > 0
    np.testing.assert_array_equal(fused.total_accept.numpy(), legacy.total_accept.numpy())
    np.testing.assert_array_equal(fused.accept_count.numpy(), legacy.accept_count.numpy())
    for name, leaf in legacy.params.items():
        np.testing.assert_array_equal(fused.params[name].numpy(), leaf.numpy())
    np.testing.assert_array_equal(fused.pending.numpy(),
                                  flat_lib.ravel_clients(legacy.pending).numpy())


def test_fused_matches_legacy_with_momentum_task():
    kw = dict(input_dim=6, hidden=(8,), num_classes=3, per_client=PER_CLIENT)
    tt = get_task("mlp", optimizer="momentum", **kw)
    params0 = tt.init_params(torch.Generator().manual_seed(3))
    data, _ = tt.make_data(torch.Generator().manual_seed(4), N)
    _, tcfg = _cfgs(max_delay_windows=4, unify_period=5)
    fused, legacy = _fused_and_legacy(tcfg, 7, 12, params0, tt, data, task=tt)
    np.testing.assert_array_equal(fused.total_accept.numpy(), legacy.total_accept.numpy())
    for name, leaf in legacy.params.items():
        np.testing.assert_array_equal(fused.params[name].numpy(), leaf.numpy())
    np.testing.assert_array_equal(fused.opt_state.numpy(), legacy.opt_state.numpy())


def test_run_windows_legacy_draws_from_the_generator_as_the_fused_engine(mlp):
    """Without injected draws both engines draw each window from their own
    generator, in the same order: one seed gives the same acceptances."""
    _, params0, _, tdata, tloss = mlp
    _, tcfg = _cfgs(max_delay_windows=4)
    tparams0 = convert.params_from_numpy(params0, "cpu")
    tq, tadj = tp.build_graph(tcfg, device="cpu")
    fused = tp.run_windows(tp.init_state(5, tcfg, tparams0, device="cpu"), tcfg, tq, tadj,
                           tloss, tdata, 12)
    legacy = tp.run_windows_legacy(tp.init_state_legacy(5, tcfg, tparams0, device="cpu"),
                                   tcfg, tq, tadj, tloss, tdata, 12)
    assert legacy.window_idx == fused.window_idx == 12
    np.testing.assert_array_equal(fused.total_accept.numpy(), legacy.total_accept.numpy())
    for name, leaf in legacy.params.items():
        np.testing.assert_array_equal(fused.params[name].numpy(), leaf.numpy())

"""repro_torch DRACO windows against the JAX reference, with injected draws.

The reference's draws come from its own key ladder (tests/_torch_draws.py)
and are fed to the port, so both compute the same window. Tolerances:
exact for Psi acceptance given the permutation, counters, the weight and
delay rings; rtol = atol = 1e-5 for one window; 1e-4 for a K-window
trajectory (per-window f32 GEMM reassociation compounds).

The channel runs with a 30 ms window so that per-link delays spread over
1..3 windows and past the ring (dropped links), which exercises every
drain bucket.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from _torch_draws import draws_chain, window_draws
from repro.core import protocol as jp
from repro.core.channel import ChannelConfig as JChannel
from repro.data.synthetic import federated_classification, make_mlp
from repro_torch import convert
from repro_torch.core import protocol as tp
from repro_torch.core.channel import ChannelConfig as TChannel
from repro_torch.data.synthetic import make_mlp as tmake_mlp
from repro_torch.data.synthetic import mlp_fns

N, PER_CLIENT = 6, 32


def _configs(channel=True, psi=3, unify=3, depth=4, local_batches=1,
             self_update=False):
    kw = dict(num_clients=N, lr=0.1, window=0.03, lambda_grad=20.0,
              lambda_tx=20.0, psi=psi, unify_period=unify,
              max_delay_windows=depth, batch_size=8,
              local_batches=local_batches, apply_self_update=self_update)
    return (jp.DracoConfig(**kw, channel=JChannel() if channel else None),
            tp.DracoConfig(**kw, channel=TChannel() if channel else None))


class Pair:
    """The same run on both sides: the reference state, graph and data,
    and the port's converted copies."""

    def __init__(self, jcfg, tcfg, seed=0):
        self.jcfg, self.tcfg = jcfg, tcfg
        k_data, k_model, k_state = jax.random.split(jax.random.PRNGKey(seed), 3)
        (xs, ys), _ = federated_classification(k_data, N, 16, 5, per_client=PER_CLIENT)
        params0, _, self.jloss, _ = make_mlp(k_model, 16, (32,), 5)
        self.jdata = (xs, ys)
        self.jstate = jp.init_state(k_state, jcfg, params0)
        self.q, self.adj = jp.build_graph(jcfg)
        self.tq, self.tadj = tp.build_graph(tcfg, device="cpu")
        self.tdata = convert.data_from_numpy((xs, ys), "cpu")
        _, self.tloss, _ = mlp_fns(2)

    def tstate(self):
        return convert.state_from_numpy(self.jstate, device="cpu")


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _assert_states_match(ts, js, tol):
    for k, v in ts.params.items():
        _close(v, js.params[k], tol)
    _close(ts.pending, js.pending, tol)
    _close(ts.buffer, js.buffer, tol)
    np.testing.assert_array_equal(ts.w_ring.numpy(), np.asarray(js.w_ring))
    np.testing.assert_array_equal(ts.delay_ring.numpy(), np.asarray(js.delay_ring))
    np.testing.assert_array_equal(ts.accept_count.numpy(), np.asarray(js.accept_count))
    np.testing.assert_array_equal(ts.total_accept.numpy(), np.asarray(js.total_accept))
    assert ts.window_idx == int(js.window_idx)


@pytest.mark.parametrize("psi", [1, 3, 6, 0])
def test_psi_accept_matches_reference_given_perm(psi):
    n = 9
    rng = np.random.default_rng(psi)
    success = rng.random((n, n)) < 0.6
    count = rng.integers(0, 4, (n,)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    ref_ok, ref_count = jp._psi_accept(key, jnp.asarray(success),
                                       jnp.asarray(count), psi)
    perm = torch.as_tensor(np.array(jax.random.permutation(key, n)))
    ok, new_count = tp._psi_accept(torch.as_tensor(success), torch.as_tensor(count),
                                   psi, perm if psi > 0 else None)
    assert new_count.dtype == torch.int32
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(new_count.numpy(), np.asarray(ref_count))


@pytest.mark.parametrize("local_batches", [1, 2])
def test_local_updates_match_reference(local_batches):
    jcfg, tcfg = _configs(local_batches=local_batches)
    pair = Pair(jcfg, tcfg)
    key = jax.random.PRNGKey(4)
    _, _, k_gsel, *_ = jax.random.split(key, 8)
    draws, _ = window_draws(key, jcfg, PER_CLIENT)
    jparams = pair.jstate.params
    ref = jp.local_updates(k_gsel, jparams, jnp.asarray(draws["grad_mask"]), jcfg,
                           pair.jloss, pair.jdata)
    got = tp.local_updates(convert.params_from_numpy(jparams, "cpu"),
                           torch.tensor(draws["grad_mask"]), tcfg, pair.tloss,
                           pair.tdata, torch.tensor(draws["batch_idx"]))
    assert draws["batch_idx"].shape == (N, local_batches, jcfg.batch_size)
    for k in got:
        _close(got[k], ref[k], 1e-5)
        idle = ~draws["grad_mask"]
        assert not got[k][torch.as_tensor(idle)].any()


def test_one_window_matches_reference():
    jcfg, tcfg = _configs(channel=True, psi=3)
    pair = Pair(jcfg, tcfg, seed=1)
    # run the reference a few windows so the ring holds live payloads,
    # then start the window under test from the same state on both sides
    js = jp.run_windows(pair.jstate, jcfg, pair.q, pair.adj, pair.jloss, pair.jdata, 4)
    ts = convert.state_from_numpy(js, device="cpu")
    draws, _ = window_draws(js.key, jcfg, PER_CLIENT)
    js = jp.draco_window(js, jcfg, pair.q, pair.adj, pair.jloss, pair.jdata)
    ts = tp.draco_window(ts, tcfg, pair.tq, pair.tadj, pair.tloss, pair.tdata,
                         draws=convert.draws_from_numpy(draws, "cpu"))
    assert ts.buffer.abs().sum() > 0
    _assert_states_match(ts, js, 1e-5)
    assert int(np.asarray(js.total_accept).sum()) > 0


@pytest.mark.parametrize("channel", [True, False], ids=["channel", "no-channel"])
@pytest.mark.parametrize("psi", [0, 3])
def test_k_windows_match_reference(channel, psi):
    """Seven windows with unification every three: the ring wraps, links
    are dropped past the ring, Psi binds and two unifications fire."""
    jcfg, tcfg = _configs(channel=channel, psi=psi)
    pair = Pair(jcfg, tcfg, seed=2)
    k = 7
    chain = draws_chain(pair.jstate.key, jcfg, PER_CLIENT, k)
    js = jp.run_windows(pair.jstate, jcfg, pair.q, pair.adj, pair.jloss, pair.jdata, k)
    ts = tp.run_windows(pair.tstate(), tcfg, pair.tq, pair.tadj, pair.tloss,
                        pair.tdata, k,
                        draws_fn=lambda w: convert.draws_from_numpy(chain[w], "cpu"))
    _assert_states_match(ts, js, 1e-4)
    if psi:
        assert int(np.asarray(js.accept_count).max()) <= psi


def test_self_update_and_deep_ring_match_reference():
    jcfg, tcfg = _configs(channel=True, psi=0, depth=8, self_update=True, unify=0)
    pair = Pair(jcfg, tcfg, seed=3)
    k = 5
    chain = draws_chain(pair.jstate.key, jcfg, PER_CLIENT, k)
    js = jp.run_windows(pair.jstate, jcfg, pair.q, pair.adj, pair.jloss, pair.jdata, k)
    ts = tp.run_windows(pair.tstate(), tcfg, pair.tq, pair.tadj, pair.tloss,
                        pair.tdata, k,
                        draws_fn=lambda w: convert.draws_from_numpy(chain[w], "cpu"))
    _assert_states_match(ts, js, 1e-4)


def test_damping_matches_reference():
    jcfg, tcfg = _configs(channel=True, psi=0, unify=0)
    pair = Pair(jcfg, tcfg, seed=4)
    damping = np.array([1.0, 0.9, 0.5, 0.25], np.float32)
    step = jax.jit(lambda s: jp.draco_window(s, jcfg, pair.q, pair.adj, pair.jloss,
                                             pair.jdata, damping=jnp.asarray(damping)))
    k = 5
    chain = draws_chain(pair.jstate.key, jcfg, PER_CLIENT, k)
    js, ts = pair.jstate, pair.tstate()
    tdamp = torch.as_tensor(damping)
    for w in range(k):
        js = step(js)
        ts = tp.draco_window(ts, tcfg, pair.tq, pair.tadj, pair.tloss, pair.tdata,
                             draws=convert.draws_from_numpy(chain[w], "cpu"),
                             damping=tdamp)
    _assert_states_match(ts, js, 1e-4)


def test_unify_matches_reference():
    jcfg, tcfg = _configs(unify=4)
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((N, 3, 2)).astype(np.float32),
              "b": rng.standard_normal((N, 2)).astype(np.float32)}
    count = np.arange(N, dtype=np.int32)
    for widx in range(12):
        rp, rc = jp._unify(jax.tree_util.tree_map(jnp.asarray, params),
                           jnp.asarray(count), jnp.int32(widx), jcfg, N)
        tparams = {k: torch.as_tensor(v) for k, v in params.items()}
        p, c = tp._unify(tparams, torch.as_tensor(count), widx, tcfg, N)
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        for k in params:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(rp[k]))
        if (widx + 1) % 4 == 0:
            hub = (widx // 4) % N
            assert torch.equal(p["w"][0], tparams["w"][hub]) and not c.any()


@pytest.mark.parametrize("depth", [2, 3, 4, 8])
def test_enqueue_slot_is_never_drained_in_its_window(depth):
    """The in-place enqueue is safe: slot widx % D is never among the
    drain's slots (widx - a) % D, a in 1..D-1."""
    for widx in range(3 * depth):
        drained = {(widx - a) % depth for a in range(depth - 1, 0, -1)}
        assert widx % depth not in drained and len(drained) == depth - 1


@pytest.mark.parametrize("channel,psi", [(True, 3), (False, 0)])
def test_sampled_draws_layout(channel, psi):
    _, tcfg = _configs(channel=channel, psi=psi, local_batches=2)
    d = tp.sample_window_draws(torch.Generator().manual_seed(0), tcfg, PER_CLIENT)
    assert d.grad_mask.shape == (N,) and d.grad_mask.dtype == torch.bool
    assert d.tx_mask.shape == (N,) and d.tx_mask.dtype == torch.bool
    assert d.batch_idx.shape == (N, 2, 8) and d.batch_idx.dtype == torch.int64
    assert 0 <= int(d.batch_idx.min()) and int(d.batch_idx.max()) < PER_CLIENT
    assert (d.fading is not None) == channel and (d.perm is not None) == (psi > 0)
    if psi:
        assert sorted(d.perm.tolist()) == list(range(N))


def test_init_state_layout():
    _, tcfg = _configs(depth=5)
    params0 = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    st = tp.init_state(7, tcfg, params0, device="cpu")
    assert st.params["w"].shape == (N, 3, 2) and st.window_idx == 0
    assert st.buffer.shape == (5, N, 8) and st.pending.shape == (N, 8)
    assert st.w_ring.shape == st.delay_ring.shape == (5, N, N)
    assert st.delay_ring.dtype == torch.int32 and st.accept_count.dtype == torch.int32
    assert st.positions.shape == (N, 2) and st.generator.device.type == "cpu"


def test_generator_runs_are_reproducible():
    _, tcfg = _configs(channel=True, psi=3)
    params0, _, loss, _ = tmake_mlp(0, 16, (8,), 5, device="cpu")
    data = (torch.randn(N, PER_CLIENT, 16, generator=torch.Generator().manual_seed(1)),
            torch.randint(0, 5, (N, PER_CLIENT), generator=torch.Generator().manual_seed(2)))
    q, adj = tp.build_graph(tcfg, device="cpu")
    runs = [tp.run_windows(tp.init_state(3, tcfg, params0, device="cpu"), tcfg, q,
                           adj, loss, data, 6) for _ in range(2)]
    for k in params0:
        assert torch.equal(runs[0].params[k], runs[1].params[k])
    assert torch.equal(runs[0].buffer, runs[1].buffer)
    assert runs[0].window_idx == 6


def test_virtual_global_model_matches_reference():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((N, 3, 2)).astype(np.float32)}
    ref = jp.virtual_global_model(jax.tree_util.tree_map(jnp.asarray, params))
    got = tp.virtual_global_model(convert.params_from_numpy(params, "cpu"))
    _close(got["w"], ref["w"], 1e-6)

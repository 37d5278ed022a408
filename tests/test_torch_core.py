"""repro_torch topology, window events and wireless channel against the
JAX reference, on the same inputs (random draws made on the JAX side and
fed to the port)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.core import channel as jchannel
from repro.core import events as jevents
from repro.core import protocol as jprotocol
from repro.core import topology as jtopology
from repro_torch.core import channel as tchannel
from repro_torch.core import events as tevents
from repro_torch.core import protocol as tprotocol
from repro_torch.core import topology as ttopology


@pytest.mark.parametrize("topology,n", [("cycle", 7), ("ring2d", 9),
                                        ("complete", 5), ("star", 6)])
@pytest.mark.parametrize("directed", [False, True])
def test_adjacency_matches_reference(topology, n, directed):
    ref = np.asarray(jtopology.adjacency(topology, n, directed=directed))
    got = ttopology.adjacency(topology, n, directed=directed, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("directed", [False, True])
def test_erdos_matches_reference_given_its_numpy_seed(directed):
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jtopology.adjacency("erdos", 10, key=key, directed=directed))
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    got = ttopology.adjacency("erdos", 10, seed=seed, directed=directed)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_topology_rejects_bad_input():
    with pytest.raises(ValueError):
        ttopology.adjacency("ring2d", 8)
    with pytest.raises(ValueError):
        ttopology.adjacency("erdos", 8)
    with pytest.raises(ValueError):
        ttopology.adjacency("hypercube", 8)


def test_row_stochastic_matches_reference_exactly():
    adj = np.array(jtopology.adjacency("erdos", 9, key=jax.random.PRNGKey(1),
                                       directed=True))
    adj[3] = False  # a sender with no out-neighbours keeps a zero row
    ref = np.asarray(jtopology.row_stochastic(jnp.asarray(adj)))
    got = ttopology.row_stochastic(torch.as_tensor(adj))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_window_event_probs_match_reference():
    for lam in (0.1, 0.3, 2.0):
        ref = float(jevents.window_event_probs(lam, 1.5))
        assert float(tevents.window_event_probs(lam, 1.5)) == pytest.approx(ref, rel=1e-6)
    lam = torch.tensor([0.1, 0.5, 3.0])
    ref = np.asarray(jevents.window_event_probs(jnp.asarray(lam.numpy()), 0.7))
    np.testing.assert_allclose(tevents.window_event_probs(lam, 0.7).numpy(), ref,
                               rtol=1e-6)


def test_sample_event_masks_rate():
    g = torch.Generator().manual_seed(0)
    m = tevents.sample_event_masks(g, 0.3, 1.0, 20_000)
    assert m.dtype == torch.bool and m.shape == (20_000,)
    p = float(tevents.window_event_probs(0.3, 1.0))
    assert abs(m.float().mean().item() - p) < 0.015


def test_place_nodes_inside_disk():
    cfg = tchannel.ChannelConfig(radius=100.0)
    pos = tchannel.place_nodes(torch.Generator().manual_seed(3), 500, cfg)
    assert pos.shape == (500, 2) and pos.dtype == torch.float32
    r = pos.norm(dim=1)
    assert float(r.max()) <= 100.0 + 1e-3
    # uniform in area: about a quarter of the nodes inside half the radius
    assert 0.18 < float((r < 50.0).float().mean()) < 0.32


def _positions(n, seed=0):
    return np.array(jchannel.place_nodes(jax.random.PRNGKey(seed), n,
                                         jchannel.ChannelConfig()))


def test_pairwise_dist_matches_reference():
    pos = _positions(12)
    pos[1] = pos[0] + 0.25  # closer than 1 m: clamped
    ref = np.asarray(jchannel.pairwise_dist(jnp.asarray(pos)))
    got = tchannel.pairwise_dist(torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert float(got[0, 1]) == 1.0


def test_interference_matches_reference():
    n = 16
    cfg = jchannel.ChannelConfig(interference_radius_frac=0.6)
    pos = _positions(n, 2)
    dist = jchannel.pairwise_dist(jnp.asarray(pos))
    h = jax.random.exponential(jax.random.PRNGKey(3), (n, n))
    p_rx = cfg.tx_power_w * h * dist ** (-cfg.path_loss_exp)
    tx = np.array(jax.random.uniform(jax.random.PRNGKey(4), (n,)) < 0.5)
    ref = np.asarray(jchannel.interference(dist, p_rx, jnp.asarray(tx), cfg))
    tcfg = tchannel.ChannelConfig(interference_radius_frac=0.6)
    got = tchannel.interference(torch.as_tensor(np.array(dist)),
                                torch.as_tensor(np.array(p_rx)),
                                torch.as_tensor(tx), tcfg)
    assert float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("message_bytes,gamma_max", [(596_776, 10.0),
                                                     (20_000, 0.5)])
def test_transmission_delays_match_reference(message_bytes, gamma_max):
    """Gamma within f32 tolerance, success exact. The comparison
    ``gamma <= gamma_max`` could flip on a draw within an ulp of the
    deadline; these seeds do not land there."""
    n = 20
    jcfg = jchannel.ChannelConfig(message_bytes=message_bytes, gamma_max=gamma_max)
    tcfg = tchannel.ChannelConfig(message_bytes=message_bytes, gamma_max=gamma_max)
    pos = _positions(n, 7)
    key = jax.random.PRNGKey(8)
    tx = np.array(jax.random.uniform(jax.random.PRNGKey(9), (n,)) < 0.6)
    gamma, success = jchannel.transmission_delays(key, jnp.asarray(pos),
                                                  jnp.asarray(tx), jcfg)
    fading = np.array(jax.random.exponential(key, (n, n)))
    tg, ts = tchannel.transmission_delays(torch.as_tensor(fading),
                                          torch.as_tensor(pos),
                                          torch.as_tensor(tx), tcfg)
    np.testing.assert_allclose(tg.numpy(), np.asarray(gamma), rtol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(success))
    assert 0 < int(ts.sum()) < int(tx.sum()) * n


def test_quantize_delays_matches_reference_exactly():
    """Includes delays past the ring, on the boundary (D-1) * window,
    and a float -> int32 overflow: the reference saturates that cast,
    and the port must not wrap it into a deliverable one-window delay."""
    window, D = 0.5, 4
    gamma = np.array([[0.01, 0.5, 0.51, 1.0], [1.5, 1.51, 7.0, 4.7e15],
                      [np.inf, 3e9, 0.99, 1.49], [0.0, 2.0, 1.2, 0.25]],
                     np.float32)
    rd, rok = jprotocol.quantize_delays(jnp.asarray(gamma), window, D)
    td, tok = tprotocol.quantize_delays(torch.as_tensor(gamma), window, D)
    assert td.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rok))
    assert not bool(tok[1, 3]) and not bool(tok[2, 0])

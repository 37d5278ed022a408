"""repro_torch gossip mixing (mix wrapper, reference, `core.mixing`,
the unify step and batch selection) against the JAX package.

On the CPU the port's `gossip_mix` takes its plain version; it is held
against the reference's Pallas kernel in interpret mode (as
tests/test_kernels_gossip.py runs it) and its jnp oracle, with client
counts off the 8-row tile and K with a ragged last tile, at
rtol = atol = 1e-5 (f32 sums in another order). Masks, counts, the
Psi cap given the same tie-break noise, batch selection and
unification match exactly. The kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmixing
from repro.kernels.gossip import ops as jops
from repro.kernels.gossip import ref as jref
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro_torch import convert
from repro_torch.core import flat as tflat
from repro_torch.core import mixing as tmixing
from repro_torch.kernels.gossip import ops as tops
from repro_torch.kernels.gossip import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

TOL = dict(rtol=1e-5, atol=1e-5)

# (N, K): the trainer's N = 4, clients off the 8-row tile, ragged K
SHAPES = [(4, 64), (4, 1000), (3, 513), (7, 129), (16, 512), (25, 513), (64, 300)]


def _case(n, k, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, n)).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    deltas = rng.standard_normal((n, k)).astype(np.float32)
    return q, deltas


@pytest.mark.parametrize("n,k", SHAPES)
def test_mix_matches_pallas_interpret_and_oracle(n, k):
    q, deltas = _case(n, k, seed=n * k)
    got = tops.gossip_mix(torch.as_tensor(q), torch.as_tensor(deltas))
    assert got.dtype == torch.float32 and got.shape == (n, k)
    pallas = jops.gossip_mix(jnp.asarray(q), jnp.asarray(deltas), interpret=True)
    oracle = jref.gossip_mix_ref(jnp.asarray(q), jnp.asarray(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    ref = tops.gossip_mix_reference(torch.as_tensor(q), torch.as_tensor(deltas))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_mix_bf16_accumulates_in_f32_and_keeps_dtype():
    q, deltas = _case(5, 777, seed=3)
    tq = torch.as_tensor(q)
    td = torch.as_tensor(deltas).to(torch.bfloat16)
    got = tops.gossip_mix(tq, td)
    pallas = jops.gossip_mix(jnp.asarray(q), jnp.asarray(deltas, jnp.bfloat16),
                             interpret=True)
    assert got.dtype == torch.bfloat16
    # same f32 sums rounded once to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32),
                               rtol=8e-3, atol=1e-5)
    want = (tq.T @ td.float()).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mix_ref_matches_reference_oracle():
    q, deltas = _case(6, 70, seed=1)
    got = tref.gossip_mix_ref(torch.as_tensor(q), torch.as_tensor(deltas))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.gossip_mix_ref(jnp.asarray(q), jnp.asarray(deltas))),
        **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mix_reference_in_column_slices_equals_one_gemm(monkeypatch, dtype):
    """A plane wider than `REFERENCE_MIX_COLUMNS` (olmoe's trainer plane
    on the card has 2.7e9 columns, past cuBLAS's 2^31) is mixed in column
    slices, the last one ragged: the same numbers as one GEMM."""
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.random((3, 3)).astype(np.float32))
    deltas = torch.as_tensor(rng.standard_normal((3, 1000)).astype(np.float32)).to(dtype)
    want = tops.gossip_mix_reference(q, deltas)
    monkeypatch.setattr(tops, "REFERENCE_MIX_COLUMNS", 64)
    got = tops.gossip_mix_reference(q, deltas)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mix_wrapper_rejects_what_it_cannot_take():
    q, deltas = _case(4, 10)
    with pytest.raises(ValueError, match=r"\(N, N\)"):
        tops.gossip_mix(torch.as_tensor(q[:3]), torch.as_tensor(deltas))
    with pytest.raises(TypeError, match="not supported"):
        tops.gossip_mix(torch.as_tensor(q), torch.as_tensor(deltas).double())


def test_mix_counts_no_launch_on_the_cpu():
    q, deltas = _case(4, 10)
    before = tops.gossip_mix.launches
    tops.gossip_mix(torch.as_tensor(q), torch.as_tensor(deltas))
    assert tops.gossip_mix.launches == before


def test_mix_conserves_each_senders_mass():
    """Row-stochastic Q: every sender's delta is spread with total
    weight 1, so the column sums of the mixed plane equal the input's."""
    q, deltas = _case(9, 50, seed=4)
    got = tops.gossip_mix(torch.as_tensor(q), torch.as_tensor(deltas))
    np.testing.assert_allclose(got.sum(0).numpy(), deltas.sum(0), rtol=1e-5, atol=1e-5)


def _tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal((n, 3)).astype(np.float32),
            "w": {"k": rng.standard_normal((n, 4, 5)).astype(np.float32),
                  "a": rng.standard_normal((n, 2)).astype(np.float32)}}


def test_mix_dense_and_apply_mix_match_reference():
    n = 5
    q, _ = _case(n, 1, seed=5)
    deltas, params = _tree(n, 6), _tree(n, 7)
    tq = torch.as_tensor(q)
    tdeltas = convert.params_from_numpy(deltas, "cpu")
    tparams = convert.params_from_numpy(params, "cpu")
    jdeltas = jax.tree_util.tree_map(jnp.asarray, deltas)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    got = tmixing.mix_dense(tq, tdeltas)
    want = jmixing.mix_dense(jnp.asarray(q), jdeltas, use_kernel=True, interpret=True)
    for g, w in zip(tflat.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    new = tmixing.apply_mix(tparams, tq, tdeltas)
    jnew = jmixing.apply_mix(jparams, jnp.asarray(q), jdeltas)
    for g, w in zip(tflat.tree_leaves(new), jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the in-place form adds the same thing
    plane = tmixing.mix_plane(tq, tflat.ravel_clients(tdeltas))
    tmixing.add_plane_(tparams, plane, tflat.spec_of(tparams))
    for a, b in zip(tflat.tree_leaves(tparams), tflat.tree_leaves(new)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _masked_q(n, seed, drop=0.3):
    rng = np.random.default_rng(seed)
    q = rng.random((n, n)).astype(np.float32)
    q[rng.random((n, n)) < drop] = 0.0
    np.fill_diagonal(q, 0.0)
    # exact ties between senders, which the noise must break
    q[0, 1] = q[2, 1] = q[3, 1] = 0.25
    return q


@pytest.mark.parametrize("n,psi", [(4, 1), (6, 2), (9, 3), (5, 5), (7, 8)])
def test_psi_cap_mask_with_injected_noise_matches_exactly(n, psi):
    key = jax.random.fold_in(jax.random.PRNGKey(11), n * 10 + psi)
    q = _masked_q(n, seed=n + psi)
    # the reference draws its tie-break inside; draw the same numbers here
    noise = np.array(jax.random.uniform(key, (n, n), minval=0.0, maxval=1e-6))
    want = jmixing.psi_cap_mask(key, jnp.asarray(q), psi)
    got = tmixing.psi_cap_mask(torch.as_tensor(q), psi, noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = tmixing.receive_counts(got)
    assert int(counts.max()) <= psi
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jmixing.receive_counts(want)))


def test_psi_cap_mask_draws_its_own_noise():
    q = torch.as_tensor(_masked_q(6, seed=1))
    gen = torch.Generator().manual_seed(0)
    got = tmixing.psi_cap_mask(q, 2, generator=gen)
    assert int(tmixing.receive_counts(got).max()) <= 2
    assert bool(((got == q) | (got == 0)).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_receive_counts_match_reference(seed):
    q = _masked_q(7, seed=seed, drop=0.5)
    np.testing.assert_array_equal(
        tmixing.receive_counts(torch.as_tensor(q)).numpy(),
        np.asarray(jmixing.receive_counts(jnp.asarray(q))))


@pytest.mark.parametrize("per_client,b", [(16, 2), (8, 3), (2, 2), (5, 1)])
def test_select_batch_matches_reference(per_client, b):
    tok = np.random.default_rng(per_client).integers(0, 100, (3, per_client, 4))
    for idx in range(12):
        got = ttrain.select_batch({"tokens": torch.as_tensor(tok)}, idx, b)
        want = jtrain.select_batch({"tokens": jnp.asarray(tok)}, idx, b)
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


@pytest.mark.parametrize("hub", [0, 2, 3])
def test_unify_step_matches_reference(hub):
    params = _tree(4, 12)
    tparams = convert.params_from_numpy(params, "cpu")
    got = tsteps.make_unify_step(None, None)(tparams, hub)
    want = jsteps.make_unify_step(None, None)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(hub, jnp.int32))
    for g, w in zip(tflat.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        tsteps.make_unify_step(None, mesh=object())

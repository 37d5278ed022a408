"""repro_torch bucketed gossip enqueue against the JAX reference.

On the CPU the port's `gossip_enqueue` takes its plain version; it is
held against the reference's Pallas kernel in interpret mode
(``gossip_enqueue(use_kernel=True, interpret=True)``) on the edge cases
the Hopper kernel must also meet: ring depths D in {2, 4, 8}, clients off
any tile grid, K with a ragged last tile, bf16 payloads with f32 and
bf16 outputs, and buckets that sum to the full mix. Tolerance rtol = atol
= 1e-5 in f32 (f32 sums in another order); a bf16 output within one bf16
rounding step (rtol 2^-8) of the reference's, since the f32 sums of the
two packages may sit on either side of a rounding boundary. The kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip import ops as jops
from repro_torch.kernels.gossip import ops as tops
from repro_torch.kernels.gossip import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -8, atol=1e-5)


def _case(n, k, buckets, seed=0):
    """w_stack (J, N, N) f32: a row-stochastic Q split by a random
    per-link delay bucket (each edge in exactly one bucket); pending
    (N, K) f32."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, n))
    q = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    delay = rng.integers(1, buckets + 1, (n, n))
    w = np.stack([q * (delay == b) for b in range(1, buckets + 1)]).astype(np.float32)
    pending = rng.standard_normal((n, k)).astype(np.float32)
    return w, pending


def _reference(w, pending, **kw):
    return np.asarray(jops.gossip_enqueue(jnp.asarray(w), jnp.asarray(pending),
                                          use_kernel=True, interpret=True,
                                          block_d=128, **kw))


@pytest.mark.parametrize("depth", [2, 4, 8])
def test_enqueue_matches_pallas_interpret_across_ring_depths(depth):
    w, pending = _case(16, 256, depth - 1, seed=depth)
    got = tops.gossip_enqueue(torch.as_tensor(w), torch.as_tensor(pending))
    assert got.shape == (depth - 1, 16, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _reference(w, pending), **TOL)


@pytest.mark.parametrize("n", [25, 7])
def test_enqueue_clients_off_the_tile_grid(n):
    w, pending = _case(n, 192, 3, seed=n)
    got = tops.gossip_enqueue(torch.as_tensor(w), torch.as_tensor(pending))
    np.testing.assert_allclose(got.numpy(), _reference(w, pending), **TOL)


def test_enqueue_ragged_k():
    w, pending = _case(8, 513, 3, seed=1)
    got = tops.gossip_enqueue(torch.as_tensor(w), torch.as_tensor(pending))
    assert got.shape == (3, 8, 513)
    np.testing.assert_allclose(got.numpy(), _reference(w, pending), **TOL)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_enqueue_bf16_payload_accumulates_in_f32(out):
    w, pending = _case(16, 256, 3, seed=3)
    p16 = jnp.asarray(pending, jnp.bfloat16)
    want = np.asarray(jops.gossip_enqueue(
        jnp.asarray(w), p16, use_kernel=True, interpret=True, block_d=128,
        out_dtype=jnp.dtype(out)), np.float32)
    t16 = torch.as_tensor(np.asarray(p16, np.float32)).to(torch.bfloat16)
    got = tops.gossip_enqueue(torch.as_tensor(w), t16, out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(TOL if out == "float32" else BF16_TOL))
    # the default output dtype follows the payload's
    assert tops.gossip_enqueue(torch.as_tensor(w), t16).dtype == torch.bfloat16


def test_enqueue_buckets_sum_to_full_mix():
    """Buckets partition the edge set, so the bucketed outputs sum to the
    unbucketed gossip mix."""
    w, pending = _case(10, 96, 4, seed=42)
    got = tops.gossip_enqueue(torch.as_tensor(w), torch.as_tensor(pending))
    full = tops.gossip_mix_reference(torch.as_tensor(w.sum(0)), torch.as_tensor(pending))
    torch.testing.assert_close(got.sum(0), full, rtol=1e-4, atol=1e-4)


def test_enqueue_reference_is_the_plain_einsum():
    w, pending = _case(6, 40, 3, seed=5)
    tw, tp = torch.as_tensor(w), torch.as_tensor(pending)
    want = np.einsum("jnm,nk->jmk", w.astype(np.float64), pending.astype(np.float64))
    got = tops.gossip_enqueue_reference(tw, tp)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, tref.gossip_enqueue_ref(tw, tp), rtol=0, atol=0)
    torch.testing.assert_close(tops.gossip_enqueue(tw, tp), got, rtol=0, atol=0)


def test_enqueue_rejects_mismatched_shapes_and_dtypes():
    w, pending = _case(6, 40, 3)
    tw, tp = torch.as_tensor(w), torch.as_tensor(pending)
    with pytest.raises(ValueError, match=r"\(J, N, N\)"):
        tops.gossip_enqueue(tw[:, :5], tp)
    with pytest.raises(ValueError, match=r"\(J, N, N\)"):
        tops.gossip_enqueue(tw, tp[:5])
    with pytest.raises(TypeError, match="enqueue"):
        tops.gossip_enqueue(tw, tp.double())
    with pytest.raises(TypeError, match="enqueue"):
        tops.gossip_enqueue(tw, tp, out_dtype=torch.float16)

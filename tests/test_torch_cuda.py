"""repro_torch on the card: the drain and mix kernels against their
plain versions, the windowed main path launching the drain once per
window, and the trainer launching the mix once per step.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gossip import ops

# (J, N, M, K, ring rows, live buckets): the main path's widths, clients
# off any tile grid, ragged K, D in {2, 4, 8}, rectangular, N = M = 64
CASES = {
    "main-live3": (3, 25, 25, 146_447, 4, 3),
    "main-live1": (3, 25, 25, 146_447, 4, 1),
    "main-live0": (3, 25, 25, 146_447, 4, 0),
    "n7-D2": (1, 7, 7, 1000, 2, 1),
    "n7-D8": (7, 7, 7, 1000, 8, 7),
    "rectangular": (3, 8, 16, 5000, 4, 3),
    "n64": (3, 64, 64, 2049, 4, 2),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the drain kernel has no CPU mode)")
    return torch.device("cuda")


def _case(device, j, n, m, k, s, live, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, m)).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    bucket = rng.integers(0, max(live, 1), (n, m))
    w = np.stack([q * (bucket == b) * (b < live) for b in range(j)]).astype(np.float32)
    ring = rng.standard_normal((s, n, k)).astype(np.float32)
    slots = [(s - 1 - a) % s for a in range(j, 0, -1)]
    return (torch.as_tensor(w, device=device),
            torch.as_tensor(ring, device=device).to(dtype), slots)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_version(cuda_device, name, dtype):
    w, ring, slots = _case(cuda_device, *CASES[name], dtype)
    before = ops.gossip_drain.launches
    got = ops.gossip_drain(w, ring, slots)
    torch.cuda.synchronize()
    assert ops.gossip_drain.launches == before + 1
    torch.testing.assert_close(got, ops.gossip_drain_reference(w, ring, slots),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_hold(cuda_device):
    w, ring, slots = _case(cuda_device, 3, 65, 65, 64, 4, 3, torch.float32)
    with pytest.raises(ValueError, match="N <= 64"):
        ops.gossip_drain(w, ring, slots)
    w, ring, slots = _case(cuda_device, 3, 8, 8, 64, 4, 3, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gossip_drain(w, ring.transpose(1, 2).contiguous().transpose(1, 2), slots)


@pytest.mark.cuda
def test_simulate_launches_the_kernel_once_per_window(cuda_device):
    from repro_torch.api import simulate
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.protocol import DracoConfig

    cfg = DracoConfig(num_clients=8, lambda_grad=0.5, lambda_tx=0.5, psi=3,
                      unify_period=10, channel=ChannelConfig())
    ops.gossip_drain.launches = 0
    state, trace = simulate("draco", cfg, task="mlp", num_steps=25, key=0,
                            eval_every=10)
    assert ops.gossip_drain.launches == 25
    assert state.params["w0"].is_cuda
    assert list(trace.step) == [10, 20, 25]
    assert all(np.isfinite(v).all() for v in trace.metrics.values())


# gossip_mix: clients off any tile grid up to the kernel's 64, K with a
# ragged last block, and the EMNIST plane width
MIX_N = (1, 3, 4, 5, 25, 64)
MIX_K = (1, 511, 513, 146_447)


def _mix_case(device, n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, n)).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    deltas = rng.standard_normal((n, k)).astype(np.float32)
    return (torch.as_tensor(q, device=device),
            torch.as_tensor(deltas, device=device).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n", MIX_N)
@pytest.mark.parametrize("k", MIX_K)
def test_mix_kernel_matches_plain_version(cuda_device, n, k):
    q, deltas = _mix_case(cuda_device, n, k, torch.float32, seed=n + k)
    before = ops.gossip_mix.launches
    got = ops.gossip_mix(q, deltas)
    torch.cuda.synchronize()
    assert ops.gossip_mix.launches == before + 1
    torch.testing.assert_close(got, ops.gossip_mix_reference(q, deltas),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4, 146_447), (25, 513), (64, 511)])
def test_mix_kernel_bf16_rounds_the_f32_sum_once(cuda_device, n, k):
    q, deltas = _mix_case(cuda_device, n, k, torch.bfloat16, seed=n)
    got = ops.gossip_mix(q, deltas)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ops.gossip_mix_reference(q, deltas).float(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_mix_kernel_past_2_to_the_31_elements(cuda_device):
    """N * K > 2^31: every row offset must be 64-bit."""
    n, k = 4, 536_870_919
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.rand((n, n), generator=gen, device=cuda_device)
    q = q / q.sum(dim=1, keepdim=True)
    deltas = torch.randn((n, k), generator=gen, device=cuda_device)
    got = ops.gossip_mix(q, deltas)
    want = ops.gossip_mix_reference(q, deltas)
    for lo in range(0, k, 1 << 27):
        torch.testing.assert_close(got[:, lo:lo + (1 << 27)], want[:, lo:lo + (1 << 27)],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_mix_kernel_rejects_what_it_cannot_hold(cuda_device):
    q, deltas = _mix_case(cuda_device, 65, 16, torch.float32)
    with pytest.raises(ValueError, match="N <= 64"):
        ops.gossip_mix(q, deltas)
    q, deltas = _mix_case(cuda_device, 4, 16, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gossip_mix(q, deltas.T.contiguous().T)


@pytest.mark.cuda
def test_trainer_launches_the_mix_once_per_step(cuda_device):
    from repro_torch.launch import train

    ops.gossip_mix.launches = 0
    losses = train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "6",
                         "--clients", "4", "--seq", "32", "--unify-every", "3",
                         "--psi", "1", "--log-every", "3"])
    assert ops.gossip_mix.launches == 6
    assert np.isfinite(losses).all()


@pytest.mark.cuda
def test_trainer_kernel_path_matches_plain_path(cuda_device):
    from repro_torch.api import make_context
    from repro_torch.configs.base import get_reduced
    from repro_torch.core.flat import tree_leaves
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.launch import train

    cfg = get_reduced("qwen2-1.5b")
    q = make_context(DracoConfig(num_clients=4, channel=None), device=cuda_device).q
    data = train.make_batches(1, cfg, 4, 8, 32, device=cuda_device)
    runs = {}
    for name, mix in (("kernel", None), ("plain", ops.gossip_mix_reference)):
        params = train.init_client_params(0, cfg, 4, cuda_device)
        gen = torch.Generator(device=cuda_device)
        losses = []
        for step in range(3):
            gen.manual_seed(step)
            q_eff = train.mixing_weights(q, 1, generator=gen)
            params, loss = train.train_step(params, train.select_batch(data, step, 2),
                                            q_eff, cfg, 3e-3, mix=mix)
            losses.append(float(loss))
        runs[name] = (losses, params)
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(runs["kernel"][1]), tree_leaves(runs["plain"][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

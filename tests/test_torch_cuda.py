"""repro_torch on the card: the drain kernel against its plain version,
and the main path launching it once per window.

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

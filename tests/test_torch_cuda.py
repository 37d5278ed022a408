"""repro_torch on the card: the drain, mix, enqueue and SSD intra-chunk
kernels against their plain versions, the windowed main path launching
the drain once per window, and the trainer launching the mix once per
step and, on an ssm or hybrid model, the SSD kernel once per block and
client, for every model family.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels.gossip import ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunk_ref

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


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


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
    """N = 65 is no longer refused (the wide route takes it, against the
    plain version); a strided ring and more than 256 buckets are."""
    w, ring, slots = _case(cuda_device, 3, 65, 65, 64, 4, 3, torch.float32)
    torch.testing.assert_close(ops.gossip_drain(w, ring, slots),
                               ops.gossip_drain_reference(w, ring, slots),
                               rtol=1e-5, atol=1e-5)
    w, ring, slots = _case(cuda_device, 3, 8, 8, 64, 4, 3, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gossip_drain(w, ring.transpose(1, 2).contiguous().transpose(1, 2), slots)
    w = torch.zeros((1, 1, 1), device=cuda_device).expand(257, 4, 4)
    with pytest.raises(ValueError, match="J <= 256"):
        ops.gossip_drain(w, torch.zeros((1, 4, 8), device=cuda_device), [0] * 257)


# the wide route (csrc/stream.cuh): clients past 64 at K under one tile,
# ragged and the EMNIST plane's width; rectangular across 64 both ways;
# bucket sets whose weights do not fit one block (J = 8, 16 at 64)
WIDE_N = (65, 100, 256)
WIDE_K = (1, 4099, 146_447)
WIDE_DRAIN = {
    **{f"n{n}-k{k}": (3, n, n, k, 4, 3) for n in WIDE_N for k in WIDE_K},
    "rect-n100-m40": (3, 100, 40, 4099, 4, 3),
    "rect-n40-m100": (3, 40, 100, 4099, 4, 3),
    "rect-n65-m130": (3, 65, 130, 4099, 4, 2),
    "j8-n64": (8, 64, 64, 4099, 9, 8),
    "j16-n64": (16, 64, 64, 4099, 17, 11),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_DRAIN))
@DTYPES
def test_wide_drain_matches_plain_version(cuda_device, name, dtype):
    j, n, m, k, s, live = WIDE_DRAIN[name]
    w, ring, slots = _case(cuda_device, j, n, m, k, s, live, dtype, seed=len(name))
    route = ops.drain_route(j, n, m, dtype, ops._max_smem("drain", 0))
    assert ops._drain_lib().drain_route(j, n, m, int(dtype == torch.bfloat16)) == \
        {"narrow": 0, "wide": 1}[route]
    # J = 8 bf16 buckets of 64 x 64 still fit the narrow route's block
    assert route == ("narrow" if (j, dtype) == (8, torch.bfloat16) else "wide")
    before = ops.gossip_drain.launches
    got = ops.gossip_drain(w, ring, slots)
    torch.cuda.synchronize()
    assert ops.gossip_drain.launches == before + 1
    torch.testing.assert_close(got, ops.gossip_drain_reference(w, ring, slots),
                               rtol=1e-5, atol=1e-5)


def _seed_case(device, r, j, n, m, k, s, dtype):
    """The seed axis: (R, J, N, M) weights whose live buckets differ per
    seed (seed 0 has none live, seed i the first i % (J + 1)) and an
    (R, S, N, K) ring, as the sweep's batched window gives it."""
    parts = [_case(device, j, n, m, k, s, i % (j + 1), dtype, seed=10 + i) for i in range(r)]
    return (torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
            parts[0][2])


# (R, J, N, M, K, ring rows): the sweep's EMNIST plane at R in {1, 2, 4,
# 8}, K under one tile, and the wide route at N = M = 100
SEED_CASES = {
    **{f"emnist-r{r}": (r, 3, 25, 25, 146_447, 4) for r in (1, 2, 4, 8)},
    "k-under-a-tile-r3": (3, 3, 7, 7, 100, 4),
    "wide-n100-r2": (2, 3, 100, 100, 4099, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SEED_CASES))
@DTYPES
def test_seed_axis_drain_equals_solo_launches(cuda_device, name, dtype):
    """One launch for R seeds: row r equals a solo launch on row r bit for
    bit, and the plain version within 1e-5."""
    r, j, n, m, k, s = SEED_CASES[name]
    w, ring, slots = _seed_case(cuda_device, r, j, n, m, k, s, dtype)
    before = ops.gossip_drain.launches
    got = ops.gossip_drain(w, ring, slots)
    torch.cuda.synchronize()
    assert ops.gossip_drain.launches == before + 1
    assert got.shape == (r, m, k) and got.dtype == torch.float32
    for i in range(r):
        assert torch.equal(got[i], ops.gossip_drain(w[i], ring[i], slots)), i
    assert not got[0].any()  # seed 0 has no live bucket
    torch.testing.assert_close(got, ops.gossip_drain_reference(w, ring, slots),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_seed_axis_drain_refuses_mismatched_seeds(cuda_device):
    w, ring, slots = _seed_case(cuda_device, 2, 3, 8, 8, 256, 4, torch.float32)
    with pytest.raises(ValueError, match="seeds"):
        ops.gossip_drain(w, ring[:1], slots)
    with pytest.raises(ValueError, match="seeds"):
        ops.gossip_drain(w[:0], ring[:0], slots)


@pytest.mark.cuda
@DTYPES
def test_wide_drain_sparse_and_empty_blocks(cuda_device, dtype):
    """A cycle's weights leave most (bucket, chunk, group) blocks empty at
    N = 200; an all-empty drain writes zeros."""
    n, k = 200, 4099
    q = torch.zeros((n, n), device=cuda_device)
    idx = torch.arange(n, device=cuda_device)
    q[idx, (idx + 1) % n] = 0.5
    q[idx, (idx - 1) % n] = 0.5
    w = torch.stack([q, torch.zeros_like(q), q * 0.5])
    ring = torch.randn((4, n, k), device=cuda_device).to(dtype)
    torch.testing.assert_close(ops.gossip_drain(w, ring, [1, 2, 3]),
                               ops.gossip_drain_reference(w, ring, [1, 2, 3]),
                               rtol=1e-5, atol=1e-5)
    zero = ops.gossip_drain(torch.zeros_like(w), ring, [1, 2, 3])
    assert torch.equal(zero, torch.zeros((n, k), device=cuda_device))


@pytest.mark.cuda
def test_wide_drain_writes_nothing_past_its_output(cuda_device):
    j, n, k = 3, 65, 4099
    w, ring, slots = _case(cuda_device, j, n, n, k, 4, 3, torch.float32)
    buf, mid = _canary(cuda_device, n * k, torch.float32)
    c_slots = (ctypes.c_int * j)(*slots)
    stream = torch.cuda.current_stream().cuda_stream
    assert ops._drain_lib().drain_launch(w.data_ptr(), ring.data_ptr(), mid.data_ptr(),
                                         c_slots, j, n, n, k, 0, stream) == 0
    torch.cuda.synchronize()
    assert bool((buf[:64] == -12345.0).all()) and bool((buf[-64:] == -12345.0).all())
    assert torch.equal(mid.view(n, k), ops.gossip_drain(w, ring, slots))


# the streamed drain's edges: payload rows at every 4- and 2-byte phase
# (N = 5 rows of odd K), K under one tile, more senders than receivers,
# and the largest staging (J = 7 buckets of 64 x 64 weights)
STREAM_CASES = {
    **{f"aligned-k{k}": (3, 5, 5, k, 4, 3) for k in (1, 3, 8, 4096, 4099)},
    "senders-over-receivers": (3, 16, 8, 5000, 4, 3),
    "largest-staging": (7, 64, 64, 4099, 8, 7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STREAM_CASES))
@DTYPES
def test_streamed_drain_edges(cuda_device, name, dtype):
    w, ring, slots = _case(cuda_device, *STREAM_CASES[name], dtype, seed=len(name))
    got = ops.gossip_drain(w, ring, slots)
    torch.testing.assert_close(got, ops.gossip_drain_reference(w, ring, slots),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@DTYPES
def test_drain_slots_out_of_order(cuda_device, dtype):
    w, ring, _ = _case(cuda_device, 3, 25, 25, 4099, 4, 3, dtype, seed=1)
    for slots in ([2, 0, 3], [1, 1, 0]):
        torch.testing.assert_close(ops.gossip_drain(w, ring, slots),
                                   ops.gossip_drain_reference(w, ring, slots),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@DTYPES
def test_drain_empty_buckets_between_live_ones(cuda_device, dtype):
    w, ring, slots = _case(cuda_device, 5, 25, 25, 4099, 6, 5, dtype, seed=2)
    w[1] = 0.0
    w[3] = 0.0
    torch.testing.assert_close(ops.gossip_drain(w, ring, slots),
                               ops.gossip_drain_reference(w, ring, slots),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_drain_refuses_above_its_shared_memory(cuda_device):
    """The wrapper's reckoning and route are the kernel's, J = 8 at N = M
    = 64 (past the narrow route's block) takes the wide route, and a
    launch that needs more shared memory than even a wide block has (a
    unit list of 256 buckets x 140 sender chunks) raises before launching."""
    lib = ops._drain_lib()
    limit = ops._max_smem("drain", 0)
    for j, n, m in ((3, 25, 25), (7, 64, 64), (8, 64, 64), (3, 8, 16), (1, 5, 5),
                    (3, 65, 65), (3, 100, 40), (16, 256, 256), (0, 100, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = int(dtype == torch.bfloat16)
            assert ops.drain_smem_bytes(j, n, m, dtype) == lib.drain_smem_bytes(j, n, m, bf16)
            assert ops.wide_smem_bytes(j, n, dtype) == lib.drain_wide_smem_bytes(j, n, bf16)
            assert {"narrow": 0, "wide": 1, None: -1}[ops.drain_route(j, n, m, dtype, limit)] \
                == lib.drain_route(j, n, m, bf16)
    assert ops.drain_route(8, 64, 64, torch.float32, limit) == "wide"
    n = 4449
    w = torch.zeros((1, 1, 1), device=cuda_device).expand(256, n, 8)
    ring = torch.zeros((1, n, 8), device=cuda_device)
    before = ops.gossip_drain.launches
    with pytest.raises(ValueError, match="shared memory"):
        ops.gossip_drain(w, ring, [0] * 256)
    assert ops.gossip_drain.launches == before


def _canary(device, numel, dtype, pad=64):
    """A buffer of `numel` + 2 * `pad` elements holding a bit pattern no
    result takes, and its middle `numel` elements."""
    buf = torch.full((numel + 2 * pad,), -12345.0, device=device).to(dtype)
    return buf, buf[pad:pad + numel]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4099])
def test_drain_writes_nothing_past_its_output(cuda_device, k):
    w, ring, slots = _case(cuda_device, 3, 5, 5, k, 4, 3, torch.float32)
    buf, mid = _canary(cuda_device, 5 * k, torch.float32)
    c_slots = (ctypes.c_int * 3)(*slots)
    stream = torch.cuda.current_stream().cuda_stream
    assert ops._drain_lib().drain_launch(w.data_ptr(), ring.data_ptr(), mid.data_ptr(),
                                         c_slots, 3, 5, 5, k, 0, stream) == 0
    torch.cuda.synchronize()
    assert bool((buf[:64] == -12345.0).all()) and bool((buf[-64:] == -12345.0).all())
    assert torch.equal(mid.view(5, k), ops.gossip_drain(w, ring, slots))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 4099])
@pytest.mark.parametrize("pending_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_enqueue_bf16_output_writes_no_byte_past_a_row(cuda_device, k, pending_dtype):
    """bf16 outputs at odd K end at every 2-byte phase; the kernel writes
    exactly the J * N * K elements, equal to the wrapper's."""
    w, pending = _enqueue_case(cuda_device, 3, 5, k, seed=k)
    pending = pending.to(pending_dtype)
    buf, mid = _canary(cuda_device, 3 * 5 * k, torch.bfloat16)
    sentinel = buf[0].clone()
    stream = torch.cuda.current_stream().cuda_stream
    assert ops._enqueue_lib().enqueue_launch(
        w.data_ptr(), pending.data_ptr(), mid.data_ptr(), 3, 5, k,
        int(pending_dtype == torch.bfloat16), 1, stream) == 0
    torch.cuda.synchronize()
    assert bool((buf[:64] == sentinel).all()) and bool((buf[-64:] == sentinel).all())
    want = ops.gossip_enqueue(w, pending, out_dtype=torch.bfloat16)
    assert torch.equal(mid.view(3, 5, k), want)
    torch.testing.assert_close(
        want.float(), ops.gossip_enqueue_reference(w, pending, out_dtype=torch.float32)
        .to(torch.bfloat16).float(), rtol=2.0 ** -8, atol=1e-5)


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


# the mix's routes at their edges (csrc/mix.cu): the narrow route's
# receivers padded to 4 and its ends, the tensor route's 64-receiver wgmma
# blocks (65, 100, 104, 105, 128), two groups (129 in two of 65) and four
# (256 in four of 64); K under one 4-column vector, odd and ragged, and the
# EMNIST width
MIX_EDGE_N = (1, 3, 4, 5, 8, 9, 25, 33, 64, 65, 100, 104, 105, 128, 129, 256)
MIX_EDGE_K = (1, 3, 5, 4099, 146_447)


def _mix_against_plain(got, q, deltas, route):
    want = ops.gossip_mix_reference(q, deltas)
    assert got.dtype == deltas.dtype and got.shape == deltas.shape
    if deltas.dtype == torch.float32 or route == "narrow":
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5, atol=1e-5)
    else:  # split-TF32 f32 sums round to the neighbouring bf16 near a tie
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", MIX_EDGE_N)
@pytest.mark.parametrize("k", MIX_EDGE_K)
@DTYPES
def test_mix_routes_match_plain_version_at_their_edges(cuda_device, n, k, dtype):
    q, deltas = _mix_case(cuda_device, n, k, dtype, seed=7 * n + k)
    route = ops.mix_route(n, dtype, ops._max_smem("mix", 0))
    assert route == ("narrow" if n <= 64 else "tensor")
    assert ops._mix_lib().mix_route(n, int(dtype == torch.bfloat16)) == \
        ops.MIX_ROUTES.index(route)
    before = ops.gossip_mix.launches
    got = ops.gossip_mix(q, deltas)
    torch.cuda.synchronize()
    assert ops.gossip_mix.launches == before + 1
    _mix_against_plain(got, q, deltas, route)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(4, 4096), (4, 4099), (25, 4099), (100, 4099)])
@DTYPES
def test_mix_kernel_takes_rows_at_any_alignment(cuda_device, n, k, dtype):
    """A contiguous plane one element into its storage: no row starts on
    16 bytes, even where K would keep them all aligned."""
    q, deltas = _mix_case(cuda_device, n, k, dtype, seed=n)
    flat = torch.zeros(n * k + 1, dtype=dtype, device=cuda_device)
    flat[1:].copy_(deltas.flatten())
    shifted = flat[1:].view(n, k)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _mix_against_plain(ops.gossip_mix(q, shifted), q, shifted,
                       ops.mix_route(n, dtype, ops._max_smem("mix", 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,route", [(272, 4099, "tensor"), (273, 4099, "wide"),
                                       (1000, 4099, "wide")])
def test_mix_kernel_takes_any_number_of_clients(cuda_device, n, k, route):
    """The tensor route's last N (five groups of 55) and, past what a
    block's Q splits hold, stream.cuh's wide route, at 1,000 clients too."""
    q, deltas = _mix_case(cuda_device, n, k, torch.float32, seed=n)
    assert ops.mix_route(n, torch.float32, ops._max_smem("mix", 0)) == route
    _mix_against_plain(ops.gossip_mix(q, deltas), q, deltas, route)


@pytest.mark.cuda
def test_mix_kernel_rejects_what_it_cannot_hold(cuda_device):
    """N = 65 is no longer refused (the wide route, against the plain
    version); a strided plane is."""
    q, deltas = _mix_case(cuda_device, 65, 16, torch.float32)
    torch.testing.assert_close(ops.gossip_mix(q, deltas), ops.gossip_mix_reference(q, deltas),
                               rtol=1e-5, atol=1e-5)
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


# gossip_enqueue: J buckets (ring depths 2, 4, 8), clients off any tile
# grid up to 64, K with a ragged last block, the windowed path's width
ENQ_J = (1, 3, 7)
ENQ_N = (7, 25, 64)
ENQ_K = (1, 513, 146_447)


def _enqueue_case(device, j, n, k, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.random((n, n)).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    delay = rng.integers(0, j, (n, n))
    w = np.stack([q * (delay == b) for b in range(j)]).astype(np.float32)
    pending = rng.standard_normal((n, k)).astype(np.float32)
    return torch.as_tensor(w, device=device), torch.as_tensor(pending, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("j", ENQ_J)
@pytest.mark.parametrize("n", ENQ_N)
@pytest.mark.parametrize("k", ENQ_K)
def test_enqueue_kernel_matches_plain_version(cuda_device, j, n, k):
    w, pending = _enqueue_case(cuda_device, j, n, k, seed=j * n + k)
    before = ops.gossip_enqueue.launches
    got = ops.gossip_enqueue(w, pending)
    torch.cuda.synchronize()
    assert ops.gossip_enqueue.launches == before + 1
    assert got.shape == (j, n, k) and got.dtype == torch.float32
    torch.testing.assert_close(got, ops.gossip_enqueue_reference(w, pending),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(25, 146_447), (7, 513)])
def test_enqueue_kernel_bf16(cuda_device, n, k):
    """bf16 payloads accumulate in f32; a bf16 output is the kernel's f32
    sum rounded once (bit for bit), within one bf16 step of the plain
    version's."""
    w, pending = _enqueue_case(cuda_device, 3, n, k, seed=n)
    p16 = pending.to(torch.bfloat16)
    out32 = ops.gossip_enqueue(w, p16, out_dtype=torch.float32)
    torch.testing.assert_close(
        out32, ops.gossip_enqueue_reference(w, p16, out_dtype=torch.float32),
        rtol=1e-5, atol=1e-5)
    out16 = ops.gossip_enqueue(w, p16)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.to(torch.bfloat16))
    torch.testing.assert_close(out16.float(), ops.gossip_enqueue_reference(w, p16).float(),
                               rtol=2.0 ** -8, atol=1e-5)
    out_f32_to_bf16 = ops.gossip_enqueue(w, pending, out_dtype=torch.bfloat16)
    assert torch.equal(out_f32_to_bf16, ops.gossip_enqueue(w, pending).to(torch.bfloat16))


@pytest.mark.cuda
def test_enqueue_kernel_rejects_what_it_cannot_hold(cuda_device):
    """N = 65 and J = 15 at N = 64 (245,760 bytes of weights, past the
    narrow route's block) are no longer refused: the wide route takes
    them, against the plain version. A strided plane and J = 0 are."""
    for j, n in ((3, 65), (15, 64)):
        w, pending = _enqueue_case(cuda_device, j, n, 16)
        torch.testing.assert_close(ops.gossip_enqueue(w, pending),
                                   ops.gossip_enqueue_reference(w, pending),
                                   rtol=1e-5, atol=1e-5)
    w, pending = _enqueue_case(cuda_device, 3, 4, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gossip_enqueue(w, pending.T.contiguous().T)
    with pytest.raises(ValueError, match="1 <= J"):
        ops.gossip_enqueue(w[:0], pending)


@pytest.mark.cuda
@pytest.mark.parametrize("n", WIDE_N)
@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_mix_matches_plain_version(cuda_device, n, k, dtype):
    q, deltas = _mix_case(cuda_device, n, k, dtype, seed=n + k)
    before = ops.gossip_mix.launches
    got = ops.gossip_mix(q, deltas)
    torch.cuda.synchronize()
    assert ops.gossip_mix.launches == before + 1 and got.dtype == dtype
    want = ops.gossip_mix_reference(q, deltas)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        # the split-TF32 product's f32 sums are within ~2^-21 of the plain
        # version's, not equal to them, so where the f32 sum lies near a
        # bf16 rounding tie the two round to neighbouring bf16 values: one
        # bf16 step apart, at most 2^-7 of the value
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-5)
        torch.testing.assert_close(got.float(), ops.gossip_mix_reference(
            q, deltas.float()), rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("j,n", [(3, 65), (3, 100), (3, 256), (8, 64), (16, 64)])
@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_enqueue_matches_plain_version(cuda_device, j, n, k, dtype):
    w, pending = _enqueue_case(cuda_device, j, n, k, seed=j * n + k)
    pending = pending.to(dtype)
    route = ops.enqueue_route(j, n, dtype, ops._max_smem("enqueue", 0))
    assert ops._enqueue_lib().enqueue_route(j, n, int(dtype == torch.bfloat16)) == \
        {"narrow": 0, "wide": 1}[route]
    assert route == ("narrow" if (j, dtype) == (8, torch.bfloat16) else "wide")
    out32 = ops.gossip_enqueue(w, pending, out_dtype=torch.float32)
    torch.testing.assert_close(
        out32, ops.gossip_enqueue_reference(w, pending, out_dtype=torch.float32),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(ops.gossip_enqueue(w, pending, out_dtype=torch.bfloat16),
                       out32.to(torch.bfloat16))


@pytest.mark.cuda
def test_wide_reckoning_matches_the_sources(cuda_device):
    """The mix's and the enqueue's wide shared memory and routes, the
    sources' against Python's."""
    mix, enq = ops._mix_lib(), ops._enqueue_lib()
    limit = ops._max_smem("enqueue", 0)
    assert limit == ops._max_smem("mix", 0) == ops._max_smem("drain", 0)
    shape = (ctypes.c_int * 2)()
    for n in (1, 25, 64, 65, 100, 129, 256, 272, 273, 328, 329, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = int(dtype == torch.bfloat16)
            assert ops.wide_smem_bytes(1, n, dtype) == mix.mix_wide_smem_bytes(n, bf16)
            route = ops.mix_route(n, dtype, limit)
            assert mix.mix_route(n, bf16) == ops.MIX_ROUTES.index(route)
            assert mix.mix_tensor_shape(n, bf16, shape) == (route == "tensor")
            if route == "tensor":
                assert tuple(shape) == ops.mix_tensor_shape(n, dtype, limit)
    for j, n in ((3, 25), (7, 64), (8, 64), (15, 64), (3, 65), (256, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = int(dtype == torch.bfloat16)
            assert ops.wide_smem_bytes(j, n, dtype) == enq.enqueue_wide_smem_bytes(j, n, bf16)
            assert ops.enqueue_smem_bytes(j, n, dtype) == enq.enqueue_smem_bytes(j, n, bf16)
            assert {"narrow": 0, "wide": 1, None: -1}[ops.enqueue_route(j, n, dtype, limit)] \
                == enq.enqueue_route(j, n, bf16)


@pytest.mark.cuda
def test_simulate_baseline_launches_the_mix_once_per_round(cuda_device):
    from repro_torch.api import simulate
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.protocol import DracoConfig

    cfg = DracoConfig(num_clients=8, channel=ChannelConfig())
    for method in ("sync-symm", "sync-push", "async-symm", "async-push"):
        ops.gossip_mix.launches = 0
        state, trace = simulate(method, cfg, task="mlp", num_steps=12, key=0, eval_every=5)
        assert ops.gossip_mix.launches == 12
        assert state.params["w0"].is_cuda and state.round_idx == 12
        assert list(trace.step) == [5, 10, 12]
        assert all(np.isfinite(v).all() for v in trace.metrics.values())


@pytest.mark.cuda
def test_simulate_past_64_clients(cuda_device):
    """draco at N = 100 launches the (wide) drain once per window, and
    sync-symm at N = 100 the (wide) mix once per round."""
    from repro_torch.api import simulate
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.protocol import DracoConfig

    cfg = DracoConfig(num_clients=100, lambda_grad=0.5, lambda_tx=0.5, psi=3,
                      unify_period=10, channel=ChannelConfig())
    ops.gossip_drain.launches = ops.gossip_mix.launches = 0
    _, trace = simulate("draco", cfg, task="mlp", num_steps=6, key=0, eval_every=3)
    assert ops.gossip_drain.launches == 6
    _, trace2 = simulate("sync-symm", cfg, task="mlp", num_steps=4, key=0, eval_every=2)
    assert ops.gossip_mix.launches == 4
    assert all(np.isfinite(v).all() for t in (trace, trace2) for v in t.metrics.values())


# ssd_chunk: (Bb, H, G, nc, Q, N, P, A scale): mamba2's block widths with
# fewer heads, groups, Q != N, ragged tiles in Q, N and P (a 900-byte bf16
# row stride in ragged-q40), a tiny case, decays strong enough that
# exp(cums_i - cums_j) overflows above the diagonal unless masked first
# (at N = 32 and at the trainer's N = 128, P = 64), Q off the 16-row MMA
# tiles with N and P ragged against them, one short chunk, an odd head
# count, and the bf16 kernel's largest Q = N = 256
SSD_CASES = {
    "mamba2-heads8": (2, 8, 1, 2, 128, 128, 64, 1.0),
    "groups2-q64-n32-p48": (2, 4, 2, 3, 64, 32, 48, 1.0),
    "ragged-q40-n40-p70": (1, 3, 3, 2, 40, 40, 70, 1.0),
    "tiny-q8": (1, 2, 1, 4, 8, 4, 4, 1.0),
    "strong-decay": (1, 4, 1, 2, 128, 32, 16, 80.0),
    "strong-decay-n128-p64": (1, 8, 1, 2, 128, 128, 64, 80.0),
    "ragged-q72-n24-p40": (2, 3, 1, 2, 72, 24, 40, 1.0),
    "one-short-chunk-q100": (2, 4, 1, 1, 100, 128, 64, 1.0),
    "heads5": (1, 5, 1, 2, 48, 64, 64, 1.0),
    "q256-n256": (1, 4, 1, 2, 256, 256, 64, 1.0),
}


def _ssd_case(device, bb, h, g, nc, q, n, p, decay, dtype, seed=0):
    """Grouped views of one projection tensor, as ssm_block makes them:
    C, B (Bb, G, nc, Q, N), x (Bb, H, nc, Q, P), cums, dt (Bb, H, nc, Q)."""
    rng = np.random.default_rng(seed)
    t = nc * q
    width = h * p + 2 * g * n
    proj = torch.as_tensor(rng.standard_normal((bb, t, width)).astype(np.float32),
                           device=device).to(dtype)
    x = proj[..., :h * p].reshape(bb, nc, q, h, p).permute(0, 3, 1, 2, 4)
    B = proj[..., h * p:h * p + g * n].reshape(bb, nc, q, g, n).permute(0, 3, 1, 2, 4)
    C = proj[..., h * p + g * n:].reshape(bb, nc, q, g, n).permute(0, 3, 1, 2, 4)
    dt = np.log1p(np.exp(rng.standard_normal((bb, h, nc, q)))).astype(np.float32)
    dt = torch.as_tensor(dt, device=device)
    a = -decay * torch.arange(1, h + 1, dtype=torch.float32, device=device)
    cums = torch.cumsum(dt * a[None, :, None, None], dim=-1)
    return C, B, x, cums, dt


def _assert_ssd_close(got, want):
    """Within 1e-4 of the largest |Y| (|S|): f32 sums of up to Q * N
    products in another order."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SSD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_chunk_kernel_matches_plain_version(cuda_device, name, dtype):
    args = _ssd_case(cuda_device, *SSD_CASES[name], dtype, seed=len(name))
    before = ssd_ops.ssd_chunk.launches
    got = ssd_ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk.launches == before + 1
    _assert_ssd_close(got, ssd_chunk_ref(*args))


@pytest.mark.cuda
def test_ssd_chunk_kernel_takes_one_group_per_head(cuda_device):
    """The reference kernel's (BH, nc, Q, N) inputs as one batch row of
    the grouped layout with a group per head, against the plain version
    in the reference's 4-D layout."""
    C, B, x, cums, dt = _ssd_case(cuda_device, 2, 4, 2, 2, 32, 16, 8, 1.0, torch.float32)
    flat = [C.repeat_interleave(2, 1), B.repeat_interleave(2, 1), x, cums, dt]
    flat = [t.reshape(8, *t.shape[2:]) for t in flat]
    y, s = ssd_ops.ssd_chunk(*(t.unsqueeze(0) for t in flat))
    assert y.shape == (1, 8, 2, 32, 8) and s.shape == (1, 8, 2, 16, 8)
    _assert_ssd_close((y[0], s[0]), ssd_chunk_ref(*flat))


@pytest.mark.cuda
def test_ssd_chunk_kernel_rejects_what_it_cannot_hold(cuda_device):
    C, B, x, cums, dt = _ssd_case(cuda_device, 1, 2, 1, 2, 16, 8, 8, 1.0, torch.float32)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_ops.ssd_chunk(C.half(), B.half(), x.half(), cums, dt)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_ops.ssd_chunk(C, B, x.to(torch.bfloat16), cums, dt)
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_chunk(C, B, x, cums.double(), dt)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        ssd_ops.ssd_chunk(C.transpose(-1, -2).contiguous().transpose(-1, -2), B, x, cums, dt)
    with pytest.raises(ValueError, match="cums and dt must be contiguous"):
        ssd_ops.ssd_chunk(C, B, x, cums.transpose(-1, -2).contiguous().transpose(-1, -2), dt)
    with pytest.raises(ValueError, match="multiple of G"):
        ssd_ops.ssd_chunk(C.expand(1, 3, *C.shape[2:]), B.expand(1, 3, *B.shape[2:]), x,
                          cums, dt)
    with pytest.raises(ValueError, match="grouped layout"):
        ssd_ops.ssd_chunk(C[0], B[0], x[0], cums[0], dt[0])


@pytest.mark.cuda
def test_ssd_chunk_kernel_raises_beyond_its_limit(cuda_device):
    """bf16 takes Q, N <= 256 (the tensor-core kernel's shared memory);
    f32 (f32 FMAs outside the tensor cores) has no such limit."""
    for q, n in ((264, 64), (64, 264)):
        args = _ssd_case(cuda_device, 1, 2, 1, 1, q, n, 16, 1.0, torch.bfloat16)
        before = ssd_ops.ssd_chunk.launches
        with pytest.raises(ValueError, match="Q, N <= 256"):
            ssd_ops.ssd_chunk(*args)
        assert ssd_ops.ssd_chunk.launches == before
        args = _ssd_case(cuda_device, 1, 2, 1, 1, q, n, 16, 1.0, torch.float32)
        got = ssd_ops.ssd_chunk(*args)
        torch.cuda.synchronize()
        _assert_ssd_close(got, ssd_chunk_ref(*args))


@pytest.mark.cuda
def test_ssd_forward_through_the_kernel_matches_plain_path(cuda_device):
    """Forward and gradients of ssd_forward: the kernel's forward with the
    plain version's backward against autograd through the plain version."""
    C, B, x, cums, dt = _ssd_case(cuda_device, 2, 4, 1, 2, 32, 16, 8, 1.0, torch.float32)
    xs = x.permute(0, 2, 3, 1, 4).reshape(2, 64, 4, 8).contiguous()
    Bs = B.permute(0, 2, 3, 1, 4).reshape(2, 64, 1, 16).contiguous()
    Cs = C.permute(0, 2, 3, 1, 4).reshape(2, 64, 1, 16).contiguous()
    dts = dt.permute(0, 2, 3, 1).reshape(2, 64, 4).contiguous()
    a = -torch.arange(1, 5, dtype=torch.float32, device=cuda_device)
    d = torch.ones(4, device=cuda_device)
    out = []
    for chunk_fn in (None, ssd_chunk_ref):
        leaves = [t.clone().requires_grad_() for t in (xs, dts, a, Bs, Cs, d)]
        before = ssd_ops.ssd_chunk.launches
        y = ssd_ops.ssd_forward(*leaves, 32, chunk_fn=chunk_fn)
        assert ssd_ops.ssd_chunk.launches == before + (chunk_fn is None)
        out.append((y, torch.autograd.grad(y.square().sum(), leaves)))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=1e-5)
    for g, w in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_mamba2_trainer_launches_the_ssd_kernel_per_block_and_client(cuda_device):
    from repro_torch.configs.base import get_reduced
    from repro_torch.launch import train

    cfg = get_reduced("mamba2-2.7b")
    ops.gossip_mix.launches = 0
    ssd_ops.ssd_chunk.launches = 0
    losses = train.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "4",
                         "--clients", "4", "--seq", "64", "--unify-every", "2",
                         "--psi", "1", "--log-every", "2"])
    assert np.isfinite(losses).all()
    assert ops.gossip_mix.launches == 4
    # remat is off in the reduced config: one launch per block, client and step
    assert ssd_ops.ssd_chunk.launches == 4 * cfg.num_layers * 4
    ssd_ops.ssd_chunk.launches = 0
    train.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "1", "--clients", "2",
                "--seq", "64"], cfg=cfg.with_(remat=True))
    # with remat the backward recomputes each block's forward
    assert ssd_ops.ssd_chunk.launches == 2 * cfg.num_layers * 2


@pytest.mark.cuda
def test_mamba2_trainer_kernel_path_matches_plain_path(cuda_device):
    from repro_torch.api import make_context
    from repro_torch.configs.base import get_reduced
    from repro_torch.core.flat import tree_leaves
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.launch import train

    cfg = get_reduced("mamba2-2.7b")
    q = make_context(DracoConfig(num_clients=4, channel=None), device=cuda_device).q
    data = train.make_batches(1, cfg, 4, 8, 64, device=cuda_device)
    runs = {}
    for name, mix, chunk_fn in (("kernel", None, None),
                                ("plain", ops.gossip_mix_reference, ssd_chunk_ref)):
        params = train.init_client_params(0, cfg, 4, cuda_device)
        gen = torch.Generator(device=cuda_device)
        losses = []
        for step in range(3):
            gen.manual_seed(step)
            q_eff = train.mixing_weights(q, 1, generator=gen)
            params, loss = train.train_step(params, train.select_batch(data, step, 2),
                                            q_eff, cfg, 3e-3, mix=mix, chunk_fn=chunk_fn)
            losses.append(float(loss))
        runs[name] = (losses, params)
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(runs["kernel"][1]), tree_leaves(runs["plain"][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


FAMILIES = ("olmoe-1b-7b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "llama-3.2-vision-11b",
            "musicgen-large")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_trainer_kernel_path_matches_plain_path(cuda_device, arch):
    """A reduced moe, hybrid, vlm or audio model (f32): 3 trainer steps
    through the mix kernel (and the SSD kernel) against 3 through their
    plain versions; one mix launch per step, and for zamba2 one SSD
    launch per Mamba2 block, client and step (remat off)."""
    from repro_torch.api import make_context
    from repro_torch.configs.base import get_reduced
    from repro_torch.core.flat import tree_leaves
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.launch import train
    from repro_torch.models.model import block_pattern

    cfg = get_reduced(arch)
    seq = 2 * cfg.ssm_chunk if cfg.family == "hybrid" else 32
    q = make_context(DracoConfig(num_clients=4, channel=None), device=cuda_device).q
    data = train.make_batches(1, cfg, 4, 8, seq, device=cuda_device)
    runs = {}
    for name, mix, chunk_fn in (("kernel", None, None),
                                ("plain", ops.gossip_mix_reference, ssd_chunk_ref)):
        params = train.init_client_params(0, cfg, 4, cuda_device)
        gen = torch.Generator(device=cuda_device)
        ops.gossip_mix.launches = ssd_ops.ssd_chunk.launches = 0
        losses = []
        for step in range(3):
            gen.manual_seed(step)
            q_eff = train.mixing_weights(q, 1, generator=gen)
            params, loss = train.train_step(params, train.select_batch(data, step, 2),
                                            q_eff, cfg, 3e-3, mix=mix, chunk_fn=chunk_fn)
            losses.append(float(loss))
        if name == "kernel":
            pattern, n_groups = block_pattern(cfg)
            assert ops.gossip_mix.launches == 3
            assert ssd_ops.ssd_chunk.launches == 3 * pattern.count("ssm") * n_groups * 4
        runs[name] = (losses, params)
    assert np.isfinite(runs["kernel"][0]).all()
    np.testing.assert_allclose(runs["kernel"][0], runs["plain"][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(runs["kernel"][1]), tree_leaves(runs["plain"][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

"""Public wrappers of the gossip kernels (port of
`repro.kernels.gossip.ops`): `gossip_drain` (delay-bucketed drain,
``csrc/drain.cu``), `gossip_mix` (row-stochastic mix, ``csrc/mix.cu``)
and `gossip_enqueue` (eager delay-bucketed mix, ``csrc/enqueue.cu``);
`gossip_drain_sharded`, the drain over a client mesh (each rank's
rectangular drain and one reduce-scatter).

Backend by tensor placement, never by option: a CUDA tensor launches the
hand-written Hopper kernel or raises; a CPU tensor takes the plain
version (`gossip_drain_reference`, `gossip_mix_reference`,
`gossip_enqueue_reference`). There is no fallback from a kernel to its
plain version. Each wrapper counts its kernel launches in
``<wrapper>.launches``. A ``meta`` tensor (the dry run's) gets an empty
result of the output's shape, and the drain and the mix report their
work to `repro_torch.kernels.work`.

Routes. Each source has a narrow route, tuned for N (and M) <= 64 with
every weight matrix in one block, and the wide route of
``csrc/stream.cuh`` (receivers in groups of at most 64, senders in chunks
of 32, each weight block staged beside its payload chunk) for every other
shape; the mix has a tensor-core route between the two (`mix_route`).
The route follows from the shape and the block's shared-memory limit
alone (`drain_route`, `enqueue_route`, `mix_route`); the sources pick the
same one (``<kernel>_route``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.gossip.ref import gossip_enqueue_ref

RING_DTYPES = (torch.float32, torch.bfloat16)
MIX_DTYPES = (torch.float32, torch.bfloat16)


# the ring of csrc/drain.cu and csrc/enqueue.cu (and csrc/stream.cuh):
# computing threads per block, receiver groups per warp (receivers padded
# to a multiple), columns per lane and per ring stage, elements per staged
# row, stages
CONSUMERS = 128
GROUPS = 4
COLS = 4
TILE = CONSUMERS // GROUPS * COLS
STAGED_ROW = TILE + 8
STAGES = 3
RING_BARRIERS = 64  # bytes of the ring's mbarriers (full and empty, 4 stages)
STORE_FLOATS = CONSUMERS // 32 * 16 * 40  # the tensor-core product's store buffers
# the wide route (csrc/stream.cuh): receivers per group at most, senders
# per chunk, columns per unit, elements per staged payload row, floats per
# staged weight row, stages, sources; the narrow routes' widths
WIDE = 64
WIDE_K = 32
WIDE_TILE = CONSUMERS
WIDE_ROW = WIDE_TILE + 8
WIDE_WROW = 72
WIDE_STAGES = 3
WIDE_MAX_S = 256
NARROW_MAX = 64


def _pad(x: int, to: int) -> int:
    return -(-x // to) * to


def _weight_row(m: int) -> int:
    """Floats per staged weight row of the CUDA-core product: `GROUPS`
    lanes' receivers, each lane's ceil(M / GROUPS) padded to a float4."""
    return GROUPS * _pad(-(-m // GROUPS), 4)


def drain_smem_bytes(j: int, n: int, m: int, dtype: torch.dtype) -> int:
    """Shared memory one block of ``csrc/drain.cu`` (its tensor-core
    product) needs: the ring's barriers, every bucket's weights (senders
    padded to 8, receivers to 16-receiver tiles, plus 8 floats up to 32
    receivers), the warps' store buffers, `STAGES` payload tiles of N
    staged rows, their row offsets, the live-bucket list and flags. The
    kernel's ``drain_smem_bytes`` computes the same."""
    elem = torch.finfo(dtype).bits // 8
    tiles = -(-m // 16)
    wrow = 16 * tiles + (8 if tiles <= 2 else 0)
    return (RING_BARRIERS + 4 * j * _pad(n, 8) * wrow + 4 * STORE_FLOATS
            + STAGES * n * (STAGED_ROW * elem + 4) + 12 * j)


def enqueue_smem_bytes(j: int, n: int, dtype: torch.dtype) -> int:
    """Shared memory one block of ``csrc/enqueue.cu`` (its CUDA-core
    product) needs: the ring's barriers, the J (N, N) weight matrices
    (`_weight_row`), `STAGES` pending tiles of N staged rows and their row
    offsets. The kernel's ``enqueue_smem_bytes`` computes the same."""
    elem = torch.finfo(dtype).bits // 8
    return RING_BARRIERS + 4 * j * n * _weight_row(n) + STAGES * n * (STAGED_ROW * elem + 4)


def wide_parts(m: int) -> int:
    """Receiver groups of the wide route for `m` receivers: at most `WIDE`
    each, balanced."""
    return -(-m // WIDE)


def wide_chunks(n: int) -> int:
    """Sender chunks of the wide route for `n` senders: `WIDE_K` each, the
    last one short."""
    return -(-n // WIDE_K)


def wide_smem_bytes(sources: int, n: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the wide route needs: the warps' store
    buffers, `WIDE_STAGES` stages of `WIDE_K`
    payload rows (`WIDE_ROW` elements) and weight rows (`WIDE_WROW` f32),
    and one 4-byte unit entry per (source, sender chunk). The sources'
    ``<kernel>_wide_smem_bytes`` compute the same."""
    elem = torch.finfo(dtype).bits // 8
    return (4 * STORE_FLOATS + WIDE_STAGES * WIDE_K * (WIDE_ROW * elem + 4 * WIDE_WROW)
            + 4 * _pad(sources * wide_chunks(n), 4))


def drain_route(j: int, n: int, m: int, dtype: torch.dtype, limit: int):
    """``"narrow"`` when N, M <= 64 and every bucket's weights fit a
    block of `limit` bytes, else ``"wide"`` when its block fits, else
    None (as ``csrc/drain.cu``'s ``route``)."""
    if not 0 <= j <= WIDE_MAX_S:
        return None
    if n <= NARROW_MAX and m <= NARROW_MAX and drain_smem_bytes(j, n, m, dtype) <= limit:
        return "narrow"
    return "wide" if wide_smem_bytes(j, n, dtype) <= limit else None


def enqueue_route(j: int, n: int, dtype: torch.dtype, limit: int):
    """As `drain_route`, for ``csrc/enqueue.cu`` (N receivers = N senders)."""
    if not 1 <= j <= WIDE_MAX_S:
        return None
    if n <= NARROW_MAX and enqueue_smem_bytes(j, n, dtype) <= limit:
        return "narrow"
    return "wide" if wide_smem_bytes(j, n, dtype) <= limit else None


# csrc/mix.cu's tensor route: columns per tile (two warpgroups of 64),
# senders per staged unit, elements per staged row (a warpgroup's), stages,
# 64-receiver blocks per group at most; the routes by their codes
MIX_TC_TILE = 128
MIX_TC_K = 32
MIX_TC_ROW = 64 + 8
MIX_TC_STAGES = 3
MIX_TC_NB = 2
MIX_TC_LD = 64 + 4  # floats per row of a warpgroup's output buffer
MIX_ROUTES = ("narrow", "tensor", "wide")


def mix_tensor_smem_bytes(n: int, nb: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the mix's tensor route needs: Q's hi and
    lo splits for `nb` 64-receiver blocks (senders padded to 8, f32), and
    for each of the two warpgroups a ring of `MIX_TC_STAGES` units of
    `MIX_TC_K` staged rows and a 64 x `MIX_TC_LD` f32 output buffer
    (``tensor_smem_bytes``)."""
    elem = torch.finfo(dtype).bits // 8
    return (2 * 4 * _pad(n, 8) * 64 * nb + 2 * MIX_TC_STAGES * MIX_TC_K * MIX_TC_ROW * elem
            + 2 * 64 * MIX_TC_LD * 4)


def mix_tensor_shape(n: int, dtype: torch.dtype, limit: int):
    """The receiver groups of the mix's tensor route for `n` clients:
    (group width, 64-receiver blocks) of the widest balanced group (at
    most ``64 * MIX_TC_NB``) whose block fits `limit` bytes; None when
    even one block of 64 does not (``tensor_shape``)."""
    for groups in range(-(-n // (64 * MIX_TC_NB)), n + 1):
        gw = -(-n // groups)
        nb = -(-gw // 64)
        if mix_tensor_smem_bytes(n, nb, dtype) <= limit:
            return gw, nb
        if nb == 1:
            return None
    return None


def mix_route(n: int, dtype: torch.dtype, limit: int) -> str:
    """``csrc/mix.cu``'s route: the CUDA cores up to N = 64, wgmma on the
    tensor cores while a block holds a receiver group's Q splits (N <= 272
    in f32, 328 in bf16 on an H100), stream.cuh's wide route past that."""
    if n <= NARROW_MAX:
        return "narrow"
    return "tensor" if mix_tensor_shape(n, dtype, limit) else "wide"


def check_smem(need: int, limit: int, what: str) -> None:
    """Raise when a block would need more shared memory than it may have."""
    if need > limit:
        raise ValueError(f"{what} need {need} bytes of shared memory, more than the "
                         f"{limit} a block has")


def bind_drain(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/drain.cu`` (or a variant)."""
    lib.drain_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.drain_launch.restype = ctypes.c_int
    if hasattr(lib, "drain_launch_seeds"):  # the designs with a seed axis
        lib.drain_launch_seeds.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.drain_launch_seeds.restype = ctypes.c_int
    lib.drain_max_j.argtypes = []
    lib.drain_max_j.restype = ctypes.c_int
    if hasattr(lib, "drain_route"):  # the designs with a wide route
        lib.drain_route.argtypes = [ctypes.c_int] * 4
        lib.drain_route.restype = ctypes.c_int
        lib.drain_wide_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.drain_wide_smem_bytes.restype = ctypes.c_longlong
    if hasattr(lib, "drain_info"):  # the designs with a persistent grid
        lib.drain_max_smem.argtypes = []
        lib.drain_max_smem.restype = ctypes.c_int
        lib.drain_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.drain_smem_bytes.restype = ctypes.c_longlong
        lib.drain_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.drain_info.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _drain_lib() -> ctypes.CDLL:
    return bind_drain(build.load("drain"))


@functools.lru_cache(maxsize=None)
def _max_smem(kernel: str, device: int) -> int:
    """The shared memory a block may opt into on `device` (bytes), as the
    library of `kernel` (``drain``, ``enqueue`` or ``mix``) reads it; read once,
    since the wrappers check it before every launch."""
    lib = {"drain": _drain_lib, "enqueue": _enqueue_lib, "mix": _mix_lib}[kernel]()
    with torch.cuda.device(device):
        return getattr(lib, f"{kernel}_max_smem")()


def bind_mix(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/mix.cu`` (or a variant,
    or an earlier design)."""
    lib.mix_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.mix_launch.restype = ctypes.c_int
    lib.mix_max_smem.argtypes = []
    lib.mix_max_smem.restype = ctypes.c_int
    if hasattr(lib, "mix_info"):  # the designs with a wide route
        lib.mix_wide_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mix_wide_smem_bytes.restype = ctypes.c_longlong
        lib.mix_info.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]
        lib.mix_info.restype = ctypes.c_int
    if hasattr(lib, "mix_route"):  # the designs with a tensor route
        lib.mix_route.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mix_route.restype = ctypes.c_int
        lib.mix_tensor_shape.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.mix_tensor_shape.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _mix_lib() -> ctypes.CDLL:
    return bind_mix(build.load("mix"))


def bind_enqueue(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/enqueue.cu`` (or a variant)."""
    lib.enqueue_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.enqueue_launch.restype = ctypes.c_int
    lib.enqueue_max_smem.argtypes = []
    lib.enqueue_max_smem.restype = ctypes.c_int
    if hasattr(lib, "enqueue_info"):  # the designs with a persistent grid
        lib.enqueue_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.enqueue_smem_bytes.restype = ctypes.c_longlong
        lib.enqueue_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.enqueue_info.restype = ctypes.c_int
    if hasattr(lib, "enqueue_route"):  # the designs with a wide route
        lib.enqueue_route.argtypes = [ctypes.c_int] * 3
        lib.enqueue_route.restype = ctypes.c_int
        lib.enqueue_wide_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.enqueue_wide_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _enqueue_lib() -> ctypes.CDLL:
    return bind_enqueue(build.load("enqueue"))


def _check(w_stack, ring, slots):
    if w_stack.dim() not in (3, 4) or ring.dim() != w_stack.dim():
        raise ValueError(f"w_stack must be (J, N, M) and ring (S, N, K), or with a leading "
                         f"seed axis (R, J, N, M) and (R, S, N, K); got "
                         f"{tuple(w_stack.shape)} and {tuple(ring.shape)}")
    if ring.dtype not in RING_DTYPES:
        raise TypeError(f"ring dtype {ring.dtype} not supported; the drain "
                        f"takes {RING_DTYPES}")
    if w_stack.dim() == 4 and (w_stack.shape[0] != ring.shape[0] or w_stack.shape[0] < 1):
        raise ValueError(f"w_stack has {w_stack.shape[0]} seeds, ring has {ring.shape[0]}; "
                         "the seed axis needs at least one on both")
    j_total, n, _ = w_stack.shape[-3:]
    if ring.shape[-2] != n:
        raise ValueError(f"w_stack has {n} senders, ring has {ring.shape[-2]}")
    if len(slots) != j_total:
        raise ValueError(f"{len(slots)} slots for {j_total} weight buckets")
    if any(not 0 <= s < ring.shape[-3] for s in slots):
        raise IndexError(f"slots {list(slots)} out of range for a ring of "
                         f"{ring.shape[-3]} rows")
    if w_stack.device != ring.device:
        raise ValueError(f"w_stack on {w_stack.device}, ring on {ring.device}")


def _host_slots(slots) -> list:
    if isinstance(slots, torch.Tensor):
        if slots.device.type != "cpu":
            raise ValueError("slots must be host integers (a CUDA tensor "
                             "would need a device read)")
        return [int(s) for s in slots.tolist()]
    return [int(s) for s in slots]


def gossip_drain(w_stack: torch.Tensor, ring: torch.Tensor,
                 slots: Sequence[int]) -> torch.Tensor:
    """Fused delay-bucketed drain: ``sum_j w_stack[j]^T @ ring[slots[j]]``.

    w_stack (J, N, M): masked weights per stored broadcast, stacked
    oldest-first (M == N on one device; rectangular for a senders
    slice); ring (S, N, K): the payload ring, f32 or bf16; slots: the J
    ring rows aligned with ``w_stack``, as host integers. Returns the f32
    (M, K) aggregate, accumulated oldest bucket first.

    The seed axis: w_stack (R, J, N, M) and ring (R, S, N, K) give the
    (R, M, K) drains ``out[r] = sum_j w_stack[r, j]^T @ ring[r,
    slots[j]]`` in one launch, the slots shared by the R seeds; row r
    equals the drain of ``(w_stack[r], ring[r])`` bit for bit.

    CUDA tensors launch ``csrc/drain.cu`` (one launch, counted in
    ``gossip_drain.launches``), on the route `drain_route` names for the
    shape (any N and M; J <= 256; a block's shared memory does not grow
    with R); CPU tensors take `gossip_drain_reference`.
    """
    slots = _host_slots(slots)
    _check(w_stack, ring, slots)
    if ring.device.type == "cpu":
        return gossip_drain_reference(w_stack, ring, slots)
    if ring.device.type == "meta":
        j_total, n, m = w_stack.shape[-3:]
        seeds = w_stack.shape[0] if w_stack.dim() == 4 else 1
        work.record("gossip_drain", work.drain(j_total, n, m, ring.shape[-1],
                                               ring.element_size(), seeds))
        return ring.new_empty(tuple(w_stack.shape[:-3]) + (m, ring.shape[-1]),
                              dtype=torch.float32)
    if ring.device.type != "cuda":
        raise ValueError(f"no drain kernel for device {ring.device}")
    lib = _drain_lib()
    j_total, n, m = w_stack.shape[-3:]
    if j_total > lib.drain_max_j():
        raise ValueError(f"drain kernel supports J <= {lib.drain_max_j()}, got J = {j_total}")
    if not ring.is_contiguous():
        raise ValueError("ring must be contiguous")
    with torch.cuda.device(ring.device):
        limit = _max_smem("drain", ring.device.index)
        if drain_route(j_total, n, m, ring.dtype, limit) is None:
            check_smem(wide_smem_bytes(j_total, n, ring.dtype), limit,
                       f"drain kernel: {j_total} buckets of {n} senders")
        out = launch_drain(lib, w_stack, ring, slots)
    gossip_drain.launches += 1
    return out


def gossip_drain_sharded(w_stack: torch.Tensor, ring: torch.Tensor,
                         slots: Sequence[int], mesh, client_axes=("data",), *,
                         collective_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Client-sharded drain: this rank's drain tile, then one reduce-scatter.

    Port of the reference's ``shard_map`` lowering. The ring is sharded
    over the *sender* axis: on each rank, ring (S, N, K) holds the stored
    broadcasts of its N senders (the rank's slice of the M clients, N =
    M / ranks), and w_stack (J, N, M) their weights against every
    receiver. The rank runs `gossip_drain` on that rectangular slice (on
    a CUDA tensor the kernel's launch, counted in
    ``gossip_drain.launches``), a partial (M, K) f32 aggregate over its
    senders; one `Mesh.reduce_scatter` over the client ranks sums the
    partials and leaves each rank its own receivers' rows, (M / ranks,
    K). The seed axis rides along: (R, J, N, M) and (R, S, N, K) give
    (R, M / ranks, K).

    `collective_dtype` is the dtype the partials cross the ranks in:
    ``torch.bfloat16`` rounds each partial to bf16 before the
    reduce-scatter (half the bytes, sums in bf16); the result is f32
    either way.

    `mesh` is a `repro_torch.launch.mesh.Mesh`; `client_axes` names its
    client axes, as the reference's argument does (a name or a tuple;
    another axis than the mesh's client axes raises). M must divide by
    the client ranks (`ValueError`, "divisible"). The per-receiver sum is
    re-associated across ranks, so the result matches `gossip_drain` on
    the whole ring up to f32 summation order.
    """
    from repro_torch.launch import mesh as mesh_lib

    axes = client_axes if isinstance(client_axes, tuple) else (client_axes,)
    if axes != mesh_lib.client_axes(mesh):
        raise ValueError(f"the drain shards over the mesh's client axes "
                         f"{mesh_lib.client_axes(mesh)}, not {axes}")
    n = w_stack.shape[-1]
    if n % mesh.size:
        raise ValueError(f"client count {n} not divisible by mesh client size {mesh.size}")
    if w_stack.shape[-2] * mesh.size != n:
        raise ValueError(f"w_stack {tuple(w_stack.shape)}: a rank holds {n // mesh.size} "
                         f"of the {n} senders")
    partial = gossip_drain(w_stack, ring, slots).to(collective_dtype)
    return mesh.reduce_scatter(partial, dim=-2).to(torch.float32)


def launch_drain(lib: ctypes.CDLL, w_stack: torch.Tensor, ring: torch.Tensor,
                 slots: Sequence[int]) -> torch.Tensor:
    """One launch of a bound drain library `lib` on the current stream,
    uncounted (`gossip_drain` checks its inputs, calls this and counts);
    w_stack (J, N, M), ring (S, N, K), slots the J ring rows, or the seed
    axis (R, J, N, M) and (R, S, N, K) through ``drain_launch_seeds``.
    Returns the f32 (M, K) or (R, M, K) aggregate; raises on a CUDA
    error, and on a seed axis for a library without one."""
    j_total, n, m = w_stack.shape[-3:]
    k = ring.shape[-1]
    w = w_stack.to(torch.float32).contiguous()
    out = torch.empty(tuple(w_stack.shape[:-3]) + (m, k), dtype=torch.float32,
                      device=ring.device)
    c_slots = (ctypes.c_int * max(j_total, 1))(*slots)
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    bf16 = int(ring.dtype == torch.bfloat16)
    if w_stack.dim() == 3:
        err = lib.drain_launch(w.data_ptr(), ring.data_ptr(), out.data_ptr(), c_slots,
                               j_total, n, m, k, bf16, stream)
    elif hasattr(lib, "drain_launch_seeds"):
        err = lib.drain_launch_seeds(
            w.data_ptr(), ring.data_ptr(), out.data_ptr(), c_slots, w_stack.shape[0],
            j_total, n, m, k, w[0].numel(), ring[0].numel(), out[0].numel(), bf16, stream)
    else:
        raise ValueError("this drain library has no seed axis")
    if err != 0:
        raise RuntimeError(f"drain kernel launch failed: CUDA error {err}")
    return out


gossip_drain.launches = 0


def gossip_drain_reference(w_stack: torch.Tensor, ring: torch.Tensor,
                           slots: Sequence[int]) -> torch.Tensor:
    """Plain version of `gossip_drain`: the reference's XLA-fallback loop.

    w_stack (J, N, M), ring (S, N, K), slots (J,) host integers. One
    GEMM per stored broadcast, oldest first, skipping buckets with no
    edge (exact: an all-zero bucket adds an exact +-0 matrix). The skip
    test reads the weights on the host; on a CUDA tensor that is a device
    read, which is why the main path never calls this on the card. With
    the seed axis, (R, J, N, M) and (R, S, N, K), the same loop for each
    seed, stacked to (R, M, K).
    """
    slots = _host_slots(slots)
    _check(w_stack, ring, slots)
    if w_stack.dim() == 4:
        return torch.stack([gossip_drain_reference(w, p, slots)
                            for w, p in zip(w_stack, ring)])
    m, k = w_stack.shape[2], ring.shape[2]
    out = torch.zeros((m, k), dtype=torch.float32, device=ring.device)
    for j, s in enumerate(slots):
        w_j = w_stack[j].to(torch.float32)
        if bool(torch.any(w_j != 0)):
            out = out + w_j.T @ ring[s].to(torch.float32)
    return out


def _check_mix(q, deltas):
    if q.dim() != 2 or deltas.dim() != 2 or q.shape[0] != q.shape[1] \
            or q.shape[0] != deltas.shape[0]:
        raise ValueError(f"q must be (N, N) and deltas (N, K); got "
                         f"{tuple(q.shape)} and {tuple(deltas.shape)}")
    if deltas.dtype not in MIX_DTYPES:
        raise TypeError(f"deltas dtype {deltas.dtype} not supported; the mix "
                        f"takes {MIX_DTYPES}")
    if q.device != deltas.device:
        raise ValueError(f"q on {q.device}, deltas on {deltas.device}")


def gossip_mix(q: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Row-stochastic gossip: ``out = Q^T @ deltas``.

    q (N, N): (sender, receiver) weights; deltas (N, K): the flat
    per-client updates, f32 or bf16. Returns (N, K) in ``deltas.dtype``,
    accumulated in f32 in sender order. No padding copy is made.

    CUDA tensors launch ``csrc/mix.cu`` (counted in
    ``gossip_mix.launches``; any N, on the route `mix_route` names;
    deltas contiguous, its rows at any alignment); CPU tensors take
    `gossip_mix_reference`.
    """
    _check_mix(q, deltas)
    if deltas.device.type == "cpu":
        return gossip_mix_reference(q, deltas)
    if deltas.device.type == "meta":
        work.record("gossip_mix", work.mix(*deltas.shape, deltas.element_size()))
        return torch.empty_like(deltas)
    if deltas.device.type != "cuda":
        raise ValueError(f"no mix kernel for device {deltas.device}")
    lib = _mix_lib()
    n = deltas.shape[0]
    if not deltas.is_contiguous():
        raise ValueError("deltas must be contiguous")
    with torch.cuda.device(deltas.device):
        limit = _max_smem("mix", deltas.device.index)
        if mix_route(n, deltas.dtype, limit) == "wide":
            check_smem(wide_smem_bytes(1, n, deltas.dtype), limit, f"mix kernel: {n} clients")
        out = launch_mix(lib, q, deltas)
    gossip_mix.launches += 1
    return out


def launch_mix(lib: ctypes.CDLL, q: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """One launch of a bound mix library `lib` on the current stream,
    uncounted (`gossip_mix` checks its inputs, calls this and counts); q
    (N, N), deltas (N, K) contiguous. Returns (N, K) in ``deltas.dtype``;
    raises on a CUDA error."""
    n, k = deltas.shape
    q32 = q.to(torch.float32).contiguous()
    out = torch.empty_like(deltas)
    stream = torch.cuda.current_stream(deltas.device).cuda_stream
    err = lib.mix_launch(q32.data_ptr(), deltas.data_ptr(), out.data_ptr(),
                         n, k, int(deltas.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"mix kernel launch failed: CUDA error {err}")
    return out


gossip_mix.launches = 0


REFERENCE_MIX_COLUMNS = 1 << 27  # columns per GEMM of a plane past them


def gossip_mix_reference(q: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Plain version of `gossip_mix`: f32 GEMMs, q (N, N), deltas (N, K)
    -> ``(q^T @ deltas)`` cast to ``deltas.dtype``. A plane of more than
    `REFERENCE_MIX_COLUMNS` columns is mixed a slice of columns at a time
    into one output (cuBLAS takes no GEMM dimension of 2^31 or more, and
    every output column is its own dot over N, so slicing changes no
    sum). The main path never calls it on the card."""
    _check_mix(q, deltas)
    qt = q.to(torch.float32).T
    k = deltas.shape[1]
    if k <= REFERENCE_MIX_COLUMNS:
        return (qt @ deltas.to(torch.float32)).to(deltas.dtype)
    out = torch.empty_like(deltas)
    for lo in range(0, k, REFERENCE_MIX_COLUMNS):
        part = deltas[:, lo:lo + REFERENCE_MIX_COLUMNS].to(torch.float32).contiguous()
        out[:, lo:lo + REFERENCE_MIX_COLUMNS] = qt @ part
    return out


def _check_enqueue(w_stack, pending, out_dtype):
    if w_stack.dim() != 3 or pending.dim() != 2 or w_stack.shape[1] != w_stack.shape[2] \
            or w_stack.shape[1] != pending.shape[0]:
        raise ValueError(f"w_stack must be (J, N, N) and pending (N, K); got "
                         f"{tuple(w_stack.shape)} and {tuple(pending.shape)}")
    if pending.dtype not in MIX_DTYPES or out_dtype not in MIX_DTYPES:
        raise TypeError(f"pending {pending.dtype} -> out {out_dtype}: the enqueue "
                        f"takes and writes {MIX_DTYPES}")
    if w_stack.device != pending.device:
        raise ValueError(f"w_stack on {w_stack.device}, pending on {pending.device}")


def gossip_enqueue(w_stack: torch.Tensor, pending: torch.Tensor, *,
                   out_dtype=None) -> torch.Tensor:
    """Batched delay-bucketed mixing: ``out[j] = w_stack[j]^T @ pending``.

    The eager lowering of bucketed gossip: one broadcast mixed into all J
    delay buckets at send time (the windowed engine stores raw payloads
    and mixes at drain time instead). w_stack (J, N, N): per-bucket
    masked weights (Q * M_d); pending (N, K) flat updates, f32 or bf16.
    Returns (J, N, K) in `out_dtype` (default ``pending.dtype``),
    accumulated in f32 in sender order. No padding copy is made.

    CUDA tensors launch ``csrc/enqueue.cu`` (counted in
    ``gossip_enqueue.launches``; any N and 1 <= J <= 256, on the route
    `enqueue_route` names; pending contiguous); CPU tensors take
    `gossip_enqueue_reference`.
    """
    out_dtype = pending.dtype if out_dtype is None else out_dtype
    _check_enqueue(w_stack, pending, out_dtype)
    if pending.device.type == "cpu":
        return gossip_enqueue_reference(w_stack, pending, out_dtype=out_dtype)
    if pending.device.type != "cuda":
        raise ValueError(f"no enqueue kernel for device {pending.device}")
    lib = _enqueue_lib()
    j_total, n, _ = w_stack.shape
    if not 1 <= j_total <= WIDE_MAX_S:
        raise ValueError(f"enqueue kernel supports 1 <= J <= {WIDE_MAX_S}, got J = {j_total}")
    if not pending.is_contiguous():
        raise ValueError("pending must be contiguous")
    with torch.cuda.device(pending.device):
        limit = _max_smem("enqueue", pending.device.index)
        if enqueue_route(j_total, n, pending.dtype, limit) is None:
            check_smem(wide_smem_bytes(j_total, n, pending.dtype), limit,
                       f"enqueue kernel: {j_total} buckets of {n} clients")
        out = launch_enqueue(lib, w_stack, pending, out_dtype)
    gossip_enqueue.launches += 1
    return out


def launch_enqueue(lib: ctypes.CDLL, w_stack: torch.Tensor, pending: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of a bound enqueue library `lib` on the current stream,
    uncounted (`gossip_enqueue` checks its inputs, calls this and
    counts); w_stack (J, N, N), pending (N, K). Returns (J, N, K) in
    `out_dtype`; raises on a CUDA error."""
    j_total, n, _ = w_stack.shape
    k = pending.shape[1]
    w = w_stack.to(torch.float32).contiguous()
    out = torch.empty((j_total, n, k), dtype=out_dtype, device=pending.device)
    stream = torch.cuda.current_stream(pending.device).cuda_stream
    err = lib.enqueue_launch(w.data_ptr(), pending.data_ptr(), out.data_ptr(),
                             j_total, n, k, int(pending.dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"enqueue kernel launch failed: CUDA error {err}")
    return out


gossip_enqueue.launches = 0


def gossip_enqueue_reference(w_stack: torch.Tensor, pending: torch.Tensor, *,
                             out_dtype=None) -> torch.Tensor:
    """Plain version of `gossip_enqueue`: the batched f32 einsum
    ``out[j] = w_stack[j]^T @ pending``, w_stack (J, N, N), pending (N,
    K) -> (J, N, K) in `out_dtype` (default ``pending.dtype``)."""
    out_dtype = pending.dtype if out_dtype is None else out_dtype
    _check_enqueue(w_stack, pending, out_dtype)
    return gossip_enqueue_ref(w_stack, pending, out_dtype=out_dtype)

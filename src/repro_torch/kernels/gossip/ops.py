"""Public wrappers of the gossip kernels (port of
`repro.kernels.gossip.ops`): `gossip_drain` (delay-bucketed drain,
``csrc/drain.cu``), `gossip_mix` (row-stochastic mix, ``csrc/mix.cu``)
and `gossip_enqueue` (eager delay-bucketed mix, ``csrc/enqueue.cu``).

Backend by tensor placement, never by option: a CUDA tensor launches the
hand-written Hopper kernel or raises; a CPU tensor takes the plain
version (`gossip_drain_reference`, `gossip_mix_reference`,
`gossip_enqueue_reference`). There is no fallback from a kernel to its
plain version. Each wrapper counts its kernel launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip.ref import gossip_enqueue_ref

RING_DTYPES = (torch.float32, torch.bfloat16)
MIX_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _drain_lib() -> ctypes.CDLL:
    lib = build.load("drain")
    lib.drain_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.drain_launch.restype = ctypes.c_int
    for fn in ("drain_max_j", "drain_max_n", "drain_max_m"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _mix_lib() -> ctypes.CDLL:
    lib = build.load("mix")
    lib.mix_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.mix_launch.restype = ctypes.c_int
    lib.mix_max_n.argtypes = []
    lib.mix_max_n.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _enqueue_lib() -> ctypes.CDLL:
    lib = build.load("enqueue")
    lib.enqueue_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.enqueue_launch.restype = ctypes.c_int
    lib.enqueue_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.enqueue_smem_bytes.restype = ctypes.c_longlong
    for fn in ("enqueue_max_n", "enqueue_max_smem"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(w_stack, ring, slots):
    if w_stack.dim() != 3 or ring.dim() != 3:
        raise ValueError(f"w_stack must be (J, N, M) and ring (S, N, K); got "
                         f"{tuple(w_stack.shape)} and {tuple(ring.shape)}")
    if ring.dtype not in RING_DTYPES:
        raise TypeError(f"ring dtype {ring.dtype} not supported; the drain "
                        f"takes {RING_DTYPES}")
    j_total, n, _ = w_stack.shape
    if ring.shape[1] != n:
        raise ValueError(f"w_stack has {n} senders, ring has {ring.shape[1]}")
    if len(slots) != j_total:
        raise ValueError(f"{len(slots)} slots for {j_total} weight buckets")
    if any(not 0 <= s < ring.shape[0] for s in slots):
        raise IndexError(f"slots {list(slots)} out of range for a ring of "
                         f"{ring.shape[0]} rows")
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

    CUDA tensors launch ``csrc/drain.cu`` (counted in
    ``gossip_drain.launches``); CPU tensors take `gossip_drain_reference`.
    """
    slots = _host_slots(slots)
    _check(w_stack, ring, slots)
    if ring.device.type == "cpu":
        return gossip_drain_reference(w_stack, ring, slots)
    if ring.device.type != "cuda":
        raise ValueError(f"no drain kernel for device {ring.device}")
    lib = _drain_lib()
    j_total, n, m = w_stack.shape
    k = ring.shape[2]
    if (j_total > lib.drain_max_j() or n > lib.drain_max_n()
            or m > lib.drain_max_m()):
        raise ValueError(
            f"drain kernel supports J <= {lib.drain_max_j()}, N <= "
            f"{lib.drain_max_n()}, M <= {lib.drain_max_m()}; got (J, N, M) = "
            f"{(j_total, n, m)}")
    if not ring.is_contiguous():
        raise ValueError("ring must be contiguous")
    w = w_stack.to(torch.float32).contiguous()
    out = torch.empty((m, k), dtype=torch.float32, device=ring.device)
    c_slots = (ctypes.c_int * max(j_total, 1))(*slots)
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream(ring.device).cuda_stream
        err = lib.drain_launch(
            w.data_ptr(), ring.data_ptr(), out.data_ptr(), c_slots, j_total,
            n, m, k, int(ring.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"drain kernel launch failed: CUDA error {err}")
    gossip_drain.launches += 1
    return out


gossip_drain.launches = 0


def gossip_drain_reference(w_stack: torch.Tensor, ring: torch.Tensor,
                           slots: Sequence[int]) -> torch.Tensor:
    """Plain version of `gossip_drain`: the reference's XLA-fallback loop.

    w_stack (J, N, M), ring (S, N, K), slots (J,) host integers. One
    GEMM per stored broadcast, oldest first, skipping buckets with no
    edge (exact: an all-zero bucket adds an exact +-0 matrix). The skip
    test reads the weights on the host; on a CUDA tensor that is a device
    read, which is why the main path never calls this on the card.
    """
    slots = _host_slots(slots)
    _check(w_stack, ring, slots)
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
    ``gossip_mix.launches``; N <= 64, deltas contiguous); CPU tensors
    take `gossip_mix_reference`.
    """
    _check_mix(q, deltas)
    if deltas.device.type == "cpu":
        return gossip_mix_reference(q, deltas)
    if deltas.device.type != "cuda":
        raise ValueError(f"no mix kernel for device {deltas.device}")
    lib = _mix_lib()
    n, k = deltas.shape
    if n > lib.mix_max_n():
        raise ValueError(f"mix kernel supports N <= {lib.mix_max_n()}, got N = {n}")
    if not deltas.is_contiguous():
        raise ValueError("deltas must be contiguous")
    q32 = q.to(torch.float32).contiguous()
    out = torch.empty_like(deltas)
    with torch.cuda.device(deltas.device):
        stream = torch.cuda.current_stream(deltas.device).cuda_stream
        err = lib.mix_launch(q32.data_ptr(), deltas.data_ptr(), out.data_ptr(),
                             n, k, int(deltas.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"mix kernel launch failed: CUDA error {err}")
    gossip_mix.launches += 1
    return out


gossip_mix.launches = 0


def gossip_mix_reference(q: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Plain version of `gossip_mix`: one f32 GEMM, q (N, N), deltas
    (N, K) -> ``(q^T @ deltas)`` cast to ``deltas.dtype``. The main path
    never calls it on the card."""
    _check_mix(q, deltas)
    out = q.to(torch.float32).T @ deltas.to(torch.float32)
    return out.to(deltas.dtype)


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
    ``gossip_enqueue.launches``; N <= 64, pending contiguous, the J
    weight matrices within a block's shared memory); CPU tensors take
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
    k = pending.shape[1]
    if n > lib.enqueue_max_n():
        raise ValueError(f"enqueue kernel supports N <= {lib.enqueue_max_n()}, got N = {n}")
    if not pending.is_contiguous():
        raise ValueError("pending must be contiguous")
    w = w_stack.to(torch.float32).contiguous()
    out = torch.empty((j_total, n, k), dtype=out_dtype, device=pending.device)
    with torch.cuda.device(pending.device):
        smem, limit = lib.enqueue_smem_bytes(j_total, n), lib.enqueue_max_smem()
        if smem > limit:
            raise ValueError(f"enqueue kernel: {j_total} buckets of {n} clients need "
                             f"{smem} bytes of shared memory, more than the {limit} a "
                             f"block has")
        stream = torch.cuda.current_stream(pending.device).cuda_stream
        err = lib.enqueue_launch(w.data_ptr(), pending.data_ptr(), out.data_ptr(),
                                 j_total, n, k, int(pending.dtype == torch.bfloat16),
                                 int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"enqueue kernel launch failed: CUDA error {err}")
    gossip_enqueue.launches += 1
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

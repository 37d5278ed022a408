"""The work of each hand-written kernel, and the least time it can take.

Every kernel of the port gets one entry here: the bytes it must move
(each input read once, each output written once) and the operations it
must do, from its shapes alone, with the products that the cheapest
route on the card issues for them and the peak rate they run at. These
are the numbers behind the bound column of PERF.md's kernel table:
`chip_smoke.py` takes its bounds from `bound_s` over these entries and
`repro_torch.launch.roofline.H100_SXM`, and the dry run's counters
(`repro_torch.launch.roofline.count_work`) read the same work for a
kernel whatever implements it: the kernel on the card, its plain version
on the CPU (whose sliced, copied arithmetic is no yardstick), or its
shape-only stand-in on the ``meta`` device.

A wrapper called on ``meta`` tensors (`gossip_drain`, `gossip_mix`,
`ssd_chunk`) returns empty results of the kernel's output shapes and
reports its work here through `record`; the counters subscribe with
`sink`. Nothing is recorded when no counter listens.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple


class KernelWork(NamedTuple):
    """``ops``: the necessary operations (2 per multiply-add); ``bytes``:
    each input read once, each output written once; ``issued``: the
    products the cheapest route that keeps the result's accuracy issues
    for ``ops``, at the rate of the `Peaks` field named ``rate``."""

    ops: float
    bytes: float
    issued: float
    rate: str


Sink = Callable[[str, KernelWork], None]

_SINKS: List[Sink] = []


@contextlib.contextmanager
def sink(fn: Sink) -> Iterator[None]:
    """Call ``fn(kernel, work)`` for every kernel call recorded inside
    the block."""
    _SINKS.append(fn)
    try:
        yield
    finally:
        _SINKS.remove(fn)


def record(kernel: str, work: KernelWork) -> None:
    for fn in list(_SINKS):
        fn(kernel, work)


def bound_s(work: KernelWork, peaks) -> Tuple[float, str]:
    """(seconds, ``"bytes"`` or ``"operations"``): the larger of the
    bytes over the card's memory rate and the issued products over
    their rate."""
    t_bytes = work.bytes / peaks.hbm_bw
    t_ops = work.issued / getattr(peaks, work.rate)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _f32(ops: float, moved: float) -> KernelWork:
    """Work whose products run as f32 multiply-adds outside the tensor cores."""
    return KernelWork(float(ops), float(moved), float(ops), "f32_flops")


def drain(j: int, n: int, m: int, k: int, elem_bytes: int, seeds: int = 1,
          live: Optional[int] = None) -> KernelWork:
    """One drain of J buckets of N senders into M receivers over K
    columns, `live` of them live (default all; the dry run cannot see
    which are): the live buckets' ring rows read once in the payload
    dtype, the J f32 weight blocks read once, the f32 (M, K) output
    written once; 2 live N M K f32 operations. Per seed, times `seeds`."""
    live = j if live is None else live
    moved = live * n * k * elem_bytes + j * n * m * 4 + m * k * 4
    return _f32(seeds * 2 * live * n * m * k, seeds * moved)


def mix(n: int, k: int, elem_bytes: int) -> KernelWork:
    """One mix of N clients over K columns: deltas read once, the output
    written once in their dtype, Q read once; 2 N^2 K f32 operations."""
    return _f32(2 * n * n * k, 2 * n * k * elem_bytes + n * n * 4)


def enqueue(j: int, n: int, k: int, in_bytes: int, out_bytes: int) -> KernelWork:
    """One enqueue of N clients' pending rows into J buckets over K
    columns: pending read once, the J outputs written once, the weights
    read once; 2 J N^2 K f32 operations."""
    return _f32(2 * j * n * n * k, n * k * in_bytes + j * n * k * out_bytes + j * n * n * 4)


def tensor_core(work: KernelWork, elem_bytes: int) -> KernelWork:
    """The same work with its f32 products on the tensor cores as the
    gossip kernels' wide route runs them: split-TF32, three products per
    useful multiply-add for an f32 payload, two for bf16."""
    return work._replace(issued=(3 if elem_bytes == 4 else 2) * work.ops, rate="tf32_flops")


def ssd_chunk(bb: int, h: int, g: int, nc: int, q: int, n: int, p: int,
              elem_bytes: int) -> KernelWork:
    """One SSD intra-chunk step: C, B (Bb, G, nc, Q, N) and x (Bb, H, nc,
    Q, P) read once in their dtype, cums and dt (Bb, H, nc, Q) in f32, Y
    and S written once in f32; the necessary products, the lower
    triangle of C B^T (N per entry) and the masked scores times X and S's
    contraction (P per entry).

    Issued on the tensor cores at f32 accuracy (at least the ~22 bits of
    a hi + lo TF32 pair; the f32 rate outside them is no floor, a
    tensor-core kernel at f32 accuracy beats it). For bf16 inputs the
    lower triangle of C B^T multiplies them exactly into f32, once at the
    bf16 rate; a product with one f32 operand takes it as three bf16
    terms (cheaper on the H100 than two TF32 terms: 3 / 989 < 2 / 495
    per TFLOP/s). For f32 inputs every product takes three TF32 terms
    (3 / 495 < 6 / 989). At the trainer's shape this is the bytes, 53.6
    MB: 0.0160 ms against 0.0075 ms of products."""
    tri = q * (q + 1) // 2
    cb = 2 * bb * h * nc * tri * n
    f32_operand = 2 * bb * h * nc * (tri * p + q * n * p)
    moved = ((2 * bb * g * nc * q * n + bb * h * nc * q * p) * elem_bytes
             + 2 * bb * h * nc * q * 4 + bb * h * nc * (q + n) * p * 4)
    if elem_bytes == 2:
        return KernelWork(float(cb + f32_operand), float(moved),
                          float(cb + 3 * f32_operand), "flops")
    return KernelWork(float(cb + f32_operand), float(moved), float(3 * (cb + f32_operand)),
                      "tf32_flops")

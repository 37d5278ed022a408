"""The Mamba2 SSD forward built on the intra-chunk kernel (port of
`repro.kernels.ssd.ops`).

`ssd_chunk` is the wrapper of ``csrc/ssd_chunk.cu``: a CUDA tensor
launches the hand-written Hopper kernel or raises, a CPU tensor takes
the plain version `ssd_chunk_ref`; there is no fallback from the kernel
to its plain version. It counts its launches in ``ssd_chunk.launches``.
A ``meta`` tensor (the dry run's) gets empty results of the outputs'
shapes and reports its work to `repro_torch.kernels.work`.
`SSDChunk` makes it differentiable: its backward recomputes
`ssd_chunk_ref` and differentiates that (the reference has no backward
kernel either; its training path differentiates plain jnp).
`ssd_forward` mirrors ``ssd_forward_kernel``: the intra-chunk step
through the kernel, the O(T / Q) inter-chunk recurrence in torch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.ssd.ref import ssd_chunk_ref

SSD_DTYPES = (torch.float32, torch.bfloat16)
TC_MAX = 256  # largest Q and N of the bf16 (tensor-core) kernel
ChunkFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` with the argument types of its ``ssd_chunk_launch``."""
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.ssd_chunk_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [strides] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    lib.ssd_chunk_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.load("ssd_chunk"))


def _check_layout(C, B, x, cums, dt):
    """Raises unless the inputs are in the grouped layout the kernel takes."""
    if C.dim() != 5 or B.shape != C.shape or x.dim() != 5 or cums.dim() != 4:
        raise ValueError(
            f"ssd_chunk takes the grouped layout C, B (Bb, G, nc, Q, N), x (Bb, H, "
            f"nc, Q, P), cums, dt (Bb, H, nc, Q); got C {tuple(C.shape)}, B "
            f"{tuple(B.shape)}, x {tuple(x.shape)}, cums {tuple(cums.shape)}")
    bb, g, nc, q, _ = C.shape
    if (x.shape[0], x.shape[2], x.shape[3]) != (bb, nc, q) or x.shape[1] % g:
        raise ValueError(f"x {tuple(x.shape)} does not fit C {tuple(C.shape)} "
                         f"(H must be a multiple of G)")
    if cums.shape != x.shape[:4] or dt.shape != x.shape[:4]:
        raise ValueError(f"cums {tuple(cums.shape)} and dt {tuple(dt.shape)} must "
                         f"be {tuple(x.shape[:4])}")


def ssd_chunk(C, B, x, cums, dt):
    """The SSD intra-chunk step: ``(Y, S)`` as `ssd_chunk_ref` computes
    them, in f32.

    The grouped layout that `ssd_forward` hands it: C, B (Bb, G, nc, Q,
    N), x (Bb, H, nc, Q, P), cums, dt (Bb, H, nc, Q), where head h reads
    group ``h // (H // G)``. Returns Y (Bb, H, nc, Q, P) and S (Bb, H,
    nc, N, P).

    CUDA tensors launch ``csrc/ssd_chunk.cu`` (counted in
    ``ssd_chunk.launches``): C, B and x f32 or bf16 of one dtype, any
    strides with a contiguous last dimension (views of the block's
    projection need no copy), cums and dt f32 and contiguous; bf16 takes
    Q, N <= 256. bf16 runs on the tensor cores with each f32 operand split
    into three bf16 terms: not equal to `ssd_chunk_ref` bit for bit, but
    within 1e-4 of its largest |Y|, |S| (the checks' tolerance; the split
    itself errs by about 2^-24 of an operand). CPU tensors take
    `ssd_chunk_ref`.
    """
    _check_layout(C, B, x, cums, dt)
    if x.device.type == "cpu":
        return ssd_chunk_ref(C, B, x, cums, dt)
    if x.device.type == "meta":
        bb, g, nc, q, n = C.shape
        h, p = x.shape[1], x.shape[4]
        work.record("ssd_chunk", work.ssd_chunk(bb, h, g, nc, q, n, p, x.element_size()))
        return (x.new_empty((bb, h, nc, q, p), dtype=torch.float32),
                x.new_empty((bb, h, nc, n, p), dtype=torch.float32))
    y, s = launch(_lib(), C, B, x, cums, dt)
    ssd_chunk.launches += 1
    return y, s


ssd_chunk.launches = 0


def launch(lib: ctypes.CDLL, C, B, x, cums, dt):
    """``(Y, S)`` from ``ssd_chunk_launch`` of `lib` on the current
    stream: `lib` is `bind` of a library built from ``csrc/ssd_chunk.cu``
    (`ssd_chunk`'s) or from a variant of it (`variants`). The inputs are
    in the grouped layout `ssd_chunk` checks; this checks their device,
    dtypes, strides and the bf16 limit. Counts nothing."""
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_chunk kernel for device {x.device}")
    if any(t.device != x.device for t in (C, B, cums, dt)):
        raise ValueError("C, B, x, cums and dt must be on one device")
    if x.dtype not in SSD_DTYPES or C.dtype != x.dtype or B.dtype != x.dtype:
        raise TypeError(f"C, B and x must share one dtype of {SSD_DTYPES}; got "
                        f"{C.dtype}, {B.dtype}, {x.dtype}")
    if cums.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError("cums and dt must be float32")
    if any(t.stride(-1) != 1 for t in (C, B, x)):
        raise ValueError("C, B and x need a contiguous last dimension")
    if not (cums.is_contiguous() and dt.is_contiguous()):
        raise ValueError("cums and dt must be contiguous")
    bb, g, nc, q, n = C.shape
    h, p = x.shape[1], x.shape[4]
    if x.dtype == torch.bfloat16 and max(q, n) > TC_MAX:
        raise ValueError(f"ssd_chunk's bf16 kernel takes Q, N <= {TC_MAX}; got Q {q}, "
                         f"N {n}")
    y = torch.empty((bb, h, nc, q, p), dtype=torch.float32, device=x.device)
    s = torch.empty((bb, h, nc, n, p), dtype=torch.float32, device=x.device)

    def strides(t):
        return (ctypes.c_longlong * 4)(*t.stride()[:4])

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk_launch(
            C.data_ptr(), B.data_ptr(), x.data_ptr(), cums.data_ptr(), dt.data_ptr(),
            y.data_ptr(), s.data_ptr(), bb, h, g, nc, q, n, p, strides(C),
            strides(B), strides(x), int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {err}")
    return y, s


class SSDChunk(torch.autograd.Function):
    """``(Y, S) = ssd_chunk(C, B, x, cums, dt)`` with the gradient of
    `ssd_chunk_ref`: the backward recomputes the plain version on the
    saved inputs under autograd and differentiates it."""

    @staticmethod
    def forward(ctx, C, B, x, cums, dt):
        ctx.save_for_backward(C, B, x, cums, dt)
        return ssd_chunk(C, B, x, cums, dt)

    @staticmethod
    def backward(ctx, grad_y, grad_s):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return (None,) * 5
        with torch.enable_grad():
            y, s = ssd_chunk_ref(*inputs)
            grads = iter(torch.autograd.grad((y, s), wanted, (grad_y, grad_s)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def ssd_chunk_autograd(C, B, x, cums, dt):
    """`ssd_chunk` with the gradient of `ssd_chunk_ref`."""
    return SSDChunk.apply(C, B, x, cums, dt)


def ssd_forward(x, dt, A, B_, C_, D, chunk: int, *,
                chunk_fn: Optional[ChunkFn] = None):
    """Full SSD forward, the semantics of ``repro.models.ssm.ssd_chunked``
    (the reference's plain chunked form) and of ``ssd_forward_kernel``.

    x (B, T, H, P); dt (B, T, H); A (H,); B_, C_ (B, T, G, N); D (H,).
    Returns y (B, T, H, P) in ``x.dtype``.

    Head-major views of x, B_ and C_ (no copy; B_ and C_ stay one per
    group), ``cums = cumsum(dt * A)`` in f32, the intra-chunk step
    through `chunk_fn` (default `ssd_chunk_autograd`: the kernel on the
    card), then the inter-chunk state recurrence as a loop over chunks
    (the reference's associative scan), ``Y_inter``, the ``D`` skip term
    and the cast back to ``x.dtype``.
    """
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = chunk
    if T % Q:
        raise ValueError(f"sequence length {T} is not a multiple of the SSD chunk "
                         f"{Q}; the sequence must be a multiple of ssm_chunk or no "
                         f"longer than it")
    nc = T // Q
    wide = torch.promote_types(x.dtype, torch.float32)  # f64 for an f64 model
    xh = x.reshape(Bb, nc, Q, H, P).permute(0, 3, 1, 2, 4)  # (Bb, H, nc, Q, P)
    Bg = B_.reshape(Bb, nc, Q, G, N).permute(0, 3, 1, 2, 4)  # (Bb, G, nc, Q, N)
    Cg = C_.reshape(Bb, nc, Q, G, N).permute(0, 3, 1, 2, 4)
    dth = dt.to(wide).reshape(Bb, nc, Q, H).permute(0, 3, 1, 2).contiguous()
    cums = torch.cumsum(dth * A.to(wide)[None, :, None, None], dim=-1)

    y_intra, s = (chunk_fn or ssd_chunk_autograd)(Cg, Bg, xh, cums, dth)

    chunk_decay = torch.exp(cums[..., -1])  # (Bb, H, nc)
    h = torch.zeros((Bb, H, N, P), dtype=wide, device=x.device)
    h_prev = []
    for c in range(nc):  # states[c] = states[c-1] * decay[c] + S[c]
        h_prev.append(h)
        h = h * chunk_decay[:, :, c, None, None] + s[:, :, c]
    h_prev = torch.stack(h_prev, dim=2)  # state before each chunk (Bb, H, nc, N, P)
    rep = H // G
    y_inter = Cg.to(wide).unsqueeze(2) @ h_prev.reshape(Bb, G, rep, nc, N, P)
    y_inter = y_inter.reshape(Bb, H, nc, Q, P) * torch.exp(cums)[..., None]
    y = (y_intra + y_inter).permute(0, 2, 3, 1, 4).reshape(Bb, T, H, P)
    y = y + x.to(wide) * D[None, None, :, None]
    return y.to(x.dtype)

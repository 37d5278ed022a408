"""FlashAttention-2 in plain PyTorch, with its own backward.

Port of `repro.models.flash`, which is pure JAX with a custom VJP and no
Pallas kernel, so this is plain torch too: no library attention kernel
is on the path. `flash_attention` is a `torch.autograd.Function` that
saves only ``(q, k, v, out, lse)`` and recomputes each block's
probabilities in the backward:

  fwd:  out_i, lse_i = online softmax over kv blocks j
  bwd:  D_i = rowsum(dout_i * out_i)
        p_ij = exp(q_i k_j^T / sqrt(d) - lse_i)
        dv_j += p_ij^T dout_i ;  dp = p o (dout_i v_j^T - D_i)
        dq_i += dp k_j ;         dk_j += dp^T q_i

Residual memory: q, k, v, out and the (B, H, S) statistics, O(S).

The reference maps over q blocks (``lax.map``) and scans the kv blocks
inside. Here the q blocks are a tensor axis and the loop runs over kv
blocks, so a layer costs one pass of a few launches per kv block, not
one per (q block, kv block) pair. Each q block still sees its kv blocks
in the reference's order, so its online softmax and its dq sum are the
reference's. Two things differ:

  - a kv block that the mask hides from every row of a q block is
    skipped for that q block. That changes nothing: a block past the
    diagonal adds ``exp(-1e30 - m) = 0`` once m is finite, and a block
    that the sliding window hides ahead of the first visible one leaves
    m at -1e30, so the reference's ``corr = exp(-1e30 - m_new) = 0``
    wipes what it added as soon as a visible block comes;
  - dk_j and dv_j sum their q blocks in one contraction, where the
    reference adds them q block after q block: the same terms in another
    order (f32 sums reordered, within 1e-5 at the tests' sizes).

Layout: q (B, H, S, hd), k/v (B, H, T, hd) (kv heads already repeated by
the caller). Causal, with an optional sliding window.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

NEG_INF = -1e30


def _active_blocks(nq: int, nk: int, bq: int, bk: int, window: int) -> List[Tuple[int, int]]:
    """For each kv block j, the range ``[lo, hi)`` of q blocks that see at
    least one of its keys: a key jk is visible from query iq when
    ``jk <= iq`` and, with a window, ``jk > iq - window``."""
    ranges = []
    for j in range(nk):
        first_key, last_key = j * bk, (j + 1) * bk - 1
        # causal: the q block's last query reaches the block's first key
        lo = min(max(0, -(-(first_key + 1) // bq) - 1), nq)
        hi = nq
        if window > 0:
            # the q block's first query still sees the block's last key
            hi = min(nq, max(0, -(-(last_key + window) // bq)))
        ranges.append((lo, max(lo, hi)))
    return ranges


def _mask(lo: int, hi: int, j: int, bq: int, bk: int, window: int, device):
    """(hi - lo, bq, bk) bool: the reference's `_mask` for q blocks lo..hi-1
    against kv block j."""
    iq = torch.arange(lo * bq, hi * bq, device=device).reshape(hi - lo, bq, 1)
    jk = (j * bk + torch.arange(bk, device=device)).reshape(1, 1, bk)
    m = jk <= iq
    if window > 0:
        m = m & (jk > iq - window)
    return m


def _scale(hd: int) -> float:
    """The reference's ``1 / sqrt(hd)`` in f32."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def _flash_fwd_impl(q, k, v, bq: int, bk: int, window: int):
    """(out (B, H, S, hd) in q's dtype, lse (B, H, S) f32)."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    nq, nk = S // bq, T // bk
    scale = _scale(hd)
    f32 = torch.float32
    qb = q.reshape(B, H, nq, bq, hd)
    acc = torch.zeros((B, H, nq, bq, hd), dtype=f32, device=q.device)
    m = torch.full((B, H, nq, bq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, nq, bq), dtype=f32, device=q.device)
    for j, (lo, hi) in enumerate(_active_blocks(nq, nk, bq, bk, window)):
        if lo == hi:
            continue
        k_j = k[:, :, j * bk:(j + 1) * bk]
        v_j = v[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bhiqd,bhkd->bhiqk", qb[:, :, lo:hi], k_j).to(f32) * scale
        s = torch.where(_mask(lo, hi, j, bq, bk, window, q.device), s, NEG_INF)
        m_i = m[:, :, lo:hi]
        m_new = torch.maximum(m_i, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_i - m_new)
        l[:, :, lo:hi] = l[:, :, lo:hi] * corr + p.sum(-1)
        pv = torch.einsum("bhiqk,bhkd->bhiqd", p.to(v_j.dtype), v_j).to(f32)
        acc[:, :, lo:hi] = acc[:, :, lo:hi] * corr[..., None] + pv
        m[:, :, lo:hi] = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype).reshape(B, H, S, hd)
    lse = (m + torch.log(l_safe)).reshape(B, H, S)
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, bq: int, bk: int, window: int):
    """(dq, dk, dv) in the inputs' dtypes: the reference's `_flash_bwd`."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    nq, nk = S // bq, T // bk
    scale = _scale(hd)
    f32 = torch.float32
    D = torch.sum(dout.to(f32) * out.to(f32), dim=-1)  # (B, H, S)
    qb = q.reshape(B, H, nq, bq, hd)
    qb32 = qb.to(f32)
    doutb = dout.to(f32).reshape(B, H, nq, bq, hd)
    lseb = lse.reshape(B, H, nq, bq)
    Db = D.reshape(B, H, nq, bq)
    dq = torch.zeros((B, H, nq, bq, hd), dtype=f32, device=q.device)
    dk = torch.zeros((B, H, T, hd), dtype=f32, device=q.device)
    dv = torch.zeros((B, H, T, hd), dtype=f32, device=q.device)
    for j, (lo, hi) in enumerate(_active_blocks(nq, nk, bq, bk, window)):
        if lo == hi:
            continue
        k_j = k[:, :, j * bk:(j + 1) * bk]
        v_j = v[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bhiqd,bhkd->bhiqk", qb[:, :, lo:hi], k_j).to(f32) * scale
        s = torch.where(_mask(lo, hi, j, bq, bk, window, q.device), s, NEG_INF)
        p = torch.exp(s - lseb[:, :, lo:hi, :, None])  # recomputed, never saved
        dout_i = doutb[:, :, lo:hi]
        dp = torch.einsum("bhiqd,bhkd->bhiqk", dout_i, v_j.to(f32))
        ds = p * (dp - Db[:, :, lo:hi, :, None]) * scale
        dq[:, :, lo:hi] += torch.einsum("bhiqk,bhkd->bhiqd", ds, k_j.to(f32))
        dk[:, :, j * bk:(j + 1) * bk] = torch.einsum("bhiqk,bhiqd->bhkd", ds,
                                                     qb32[:, :, lo:hi])
        dv[:, :, j * bk:(j + 1) * bk] = torch.einsum("bhiqk,bhiqd->bhkd", p, dout_i)
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_q, block_kv, sliding_window):
        out, lse = _flash_fwd_impl(q, k, v, block_q, block_kv, sliding_window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (block_q, block_kv, sliding_window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.blocks)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, block_q: int = 512, block_kv: int = 512,
                    sliding_window: int = 0) -> torch.Tensor:
    """Causal attention, (B, H, S, hd) -> (B, H, S, hd) in q's dtype, with
    the FlashAttention-2 backward. S must be a multiple of `block_q` and
    T of `block_kv`."""
    S, T = q.shape[2], k.shape[2]
    if S % block_q or T % block_kv:
        raise ValueError(f"S = {S}, T = {T} are not multiples of the blocks "
                         f"({block_q}, {block_kv})")
    return _FlashAttention.apply(q, k, v, block_q, block_kv, sliding_window)


__all__ = ["flash_attention"]

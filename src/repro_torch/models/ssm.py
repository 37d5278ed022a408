"""Mamba2 / SSD block, training half (port of `repro.models.ssm`;
state-space duality, arXiv:2405.21060).

Layer structure (Mamba2): in_proj -> [z | xBC | dt]; causal depthwise
conv over xBC; SSD; gated RMSNorm(y * silu(z)); out_proj.

`ssm_block` runs its SSD through `repro_torch.kernels.ssd.ops.ssd_forward`
(the mirror of the reference's ``ssd_forward_kernel`` and of its plain
``ssd_chunked``), whose intra-chunk step is the hand-written Hopper
kernel on the card, or its plain version `ssd_chunk_ref` on the CPU;
`ssd_reference` (the sequential oracle) is kept beside it for the tests.
The recurrent decode (`SSMState`, `ssm_decode_step`, O(1) a token) runs
no kernel and writes its new state into the given one in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd_forward
from repro_torch.models.layers import dense_init, rms_norm


def init_ssm(generator: torch.Generator, cfg):
    """Mamba2 block weights in ``cfg.dtype``, with the reference's init:
    ``a_log = log(1..H)``, ``ssm_d = 1`` and ``dt_bias = 0`` in f32,
    ``conv_b = gnorm = 0``."""
    d = cfg.d_model
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    H = cfg.ssm_heads
    conv_ch = di + 2 * G * N
    dtype = cfg.torch_dtype
    dev = generator.device
    d_in_proj = 2 * di + 2 * G * N + H
    f32 = torch.float32
    return {
        "in_proj": dense_init(generator, (d, d_in_proj), d, dtype),
        "conv_w": dense_init(generator, (conv_ch, cfg.ssm_conv_width),
                             cfg.ssm_conv_width, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=dev)),
        "ssm_d": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "gnorm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (di, d), di, dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B, T, ch), w (ch, W). The reference's
    shifted sum, in the same order: tap i sees x[t - (W - 1 - i)]."""
    W = w.shape[-1]
    T = x.shape[1]
    pads = [F.pad(x, (0, 0, W - 1 - i, 0))[:, :T] for i in range(W)]
    out = sum(p * w[None, None, :, i] for i, p in enumerate(pads))
    return F.silu(out + b[None, None, :])


def _split_proj(proj, cfg):
    di, N, G, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    z, xBC, dt = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)
    return z, xBC, dt


def _split_xbc(xBC, cfg):
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    x, B_, C_ = torch.split(xBC, [di, G * N, G * N], dim=-1)
    return x, B_, C_


def ssd_reference(x, dt, A, B_, C_, D, chunk: int = 0):
    """Naive sequential SSD recurrence, the oracle.

    x (B, T, H, P); dt (B, T, H); A (H,); B_, C_ (B, T, G, N); D (H,).
    h_t = exp(dt A) h_{t-1} + dt B_t (x) x_t ; y_t = C_t h_t + D x_t.
    """
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    wide = torch.promote_types(x.dtype, torch.float32)  # f64 for an f64 model
    Bh = torch.repeat_interleave(B_, rep, dim=2).to(wide)  # (B, T, H, N)
    Ch = torch.repeat_interleave(C_, rep, dim=2).to(wide)
    a = torch.exp(dt * A[None, None, :]).to(wide)  # (B, T, H)
    dt32, x32 = dt.to(wide), x.to(wide)
    h = torch.zeros((Bb, H, N, P), dtype=wide, device=x.device)
    ys = []
    for t in range(T):
        upd = (Bh[:, t] * dt32[:, t, :, None])[..., None] * x32[:, t, :, None, :]
        h = h * a[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1)  # (B, T, H, P)
    return (y + x32 * D[None, None, :, None]).to(x.dtype)


def ssm_block(params, x, cfg, *, chunk_fn=None):
    """Full Mamba2 block forward. x (B, S, d) -> (B, S, d).

    The SSD runs through `ssd_forward`; `chunk_fn` replaces its
    intra-chunk step (default: the kernel, with the plain version's
    gradient)."""
    B, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, cfg)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, B_, C_ = _split_xbc(xBC, cfg)
    xs = xs.reshape(B, S, H, P)
    B_ = B_.reshape(B, S, cfg.ssm_groups, cfg.ssm_state)
    C_ = C_.reshape(B, S, cfg.ssm_groups, cfg.ssm_state)
    wide = torch.promote_types(x.dtype, torch.float32)  # f64 for an f64 model
    dt = F.softplus(dt_raw.to(wide) + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    chunk = min(cfg.ssm_chunk, S)
    y = ssd_forward(xs, dt, A, B_, C_, params["ssm_d"], chunk, chunk_fn=chunk_fn)
    y = y.reshape(B, S, cfg.d_inner)
    gate = F.silu(z.to(wide)).to(y.dtype)
    y = rms_norm(y * gate, params["gnorm"], cfg.norm_eps)
    return y @ params["out_proj"]


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) a token)
# ---------------------------------------------------------------------------


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, W - 1, conv_ch): the last inputs of the conv
    h: torch.Tensor  # (B, H, N, P) f32 (f64 for an f64 model)

    @staticmethod
    def init(batch, cfg, dtype, device=None, lead=()):
        """Zero state, with the leading axes `lead` (a model's stacked
        groups) before the batch."""
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return SSMState(
            conv=torch.zeros((*lead, batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype,
                             device=device),
            h=torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                          dtype=torch.promote_types(dtype, torch.float32), device=device))


def ssm_decode_step(params, x, state: SSMState, cfg):
    """x (B, 1, d) -> ``(out (B, 1, d), state)``: the conv history and h
    advanced by one token and written into `state` in place."""
    B = x.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    wide = torch.promote_types(x.dtype, torch.float32)  # f64 for an f64 model
    proj = x @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, cfg)
    hist = torch.cat([state.conv, xBC], dim=1)  # (B, W, ch)
    conv_out = torch.einsum("bwc,cw->bc", hist, params["conv_w"]) + params["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]  # (B, 1, ch)

    xs, B_, C_ = _split_xbc(conv_out, cfg)
    xs = xs.reshape(B, H, P)
    rep = H // G
    Bh = torch.repeat_interleave(B_.reshape(B, G, N), rep, dim=1).to(wide)  # (B, H, N)
    Ch = torch.repeat_interleave(C_.reshape(B, G, N), rep, dim=1).to(wide)
    dt = F.softplus(dt_raw[:, 0].to(wide) + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["a_log"])
    a = torch.exp(dt * A[None, :])  # (B, H)

    h = state.h * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dt[..., None], xs.to(wide))
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    y = y + xs.to(wide) * params["ssm_d"][None, :, None]
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    gate = F.silu(z.to(wide)).to(y.dtype)
    y = rms_norm(y * gate, params["gnorm"], cfg.norm_eps)
    state.conv.copy_(hist[:, 1:])
    state.h.copy_(h)
    return y @ params["out_proj"], state

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

Tensor parallelism (`repro_torch.sharding.tp`). Given a `TP`, a block
computes the rank's own ssm heads (`rank_ssm_heads`: ceil(H / T) of
them from ``rank * ceil(H / T)`` on, the reference's padded split, the
last ranks fewer or none) on its own slices of the leaves (`_layout`):

  - ``in_proj``'s columns pack ``[z | x | B | C | dt]`` and ``conv_w``'s
    and ``conv_b``'s rows ``[x | B | C]``, so the reference's uniform
    block of them cuts across those parts. They are gathered
    (`TP.gather_partial`: the gradient is reduce-scattered back), or
    taken through `TP.copy` where they are replicated, and the rank
    slices out its heads' z, x and dt and the B and C of the groups its
    heads read, one product for all of them;
  - ``a_log``, ``ssm_d``, ``dt_bias``, ``gnorm`` and ``out_proj``'s rows
    are the rank's own block where that block holds exactly its heads;
    else sliced the same way;
  - the input goes through `TP.copy`, ``out_proj``'s rows give a partial
    output summed by `TP.reduce`; under sequence parallelism the input is
    the rank's positions, gathered along the sequence before ``in_proj``
    (`TP.gather_seq`: the causal conv and the SSD need the whole
    sequence), and the output reduce-scattered back to them
    (`TP.scatter_seq`);
  - the gated RMSNorm is over all of ``d_inner``: the sum of the rank's
    squares is summed over the model ranks in both directions
    (``TP.copy(TP.reduce(.))``: each rank differentiates only its own
    channels), then divided by ``cfg.d_inner``.

B and C are computed whole on every rank, and each rank's gradient of
them is its own heads' part, which the reduce-scatter (or the copy's
all-reduce) sums. A decode state holds the rank's heads and conv
channels (`SSMState.init` with `rank_ssm_heads`' counts).
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


def _split_proj(proj, cfg, H, G):
    """``z, xBC, dt`` of a projection of `H` ssm heads reading `G` groups."""
    di = H * cfg.ssm_head_dim
    z, xBC, dt = torch.split(proj, [di, di + 2 * G * cfg.ssm_state, H], dim=-1)
    return z, xBC, dt


def _split_xbc(xBC, cfg, H, G):
    gn = G * cfg.ssm_state
    x, B_, C_ = torch.split(xBC, [H * cfg.ssm_head_dim, gn, gn], dim=-1)
    return x, B_, C_


def rank_ssm_heads(cfg, rank: int, size: int):
    """``(h0, heads, g0, groups)``: the ssm heads ``h0 .. h0 + heads`` that
    model rank `rank` of `size` computes, ``c = ceil(H / size)`` of them
    from ``rank * c`` on (the last ranks fewer or none), and the groups
    ``g0 .. g0 + groups`` they read. A rank without heads reads the last
    group, so that its block runs the others' ops on no heads (and its
    collectives in their order). Raises `NotImplementedError` where the
    rank's heads do not read its groups in whole runs of ``H / G`` (then
    the SSD's head-to-group map is not the local one)."""
    H, G = cfg.ssm_heads, cfg.ssm_groups
    c = -(-H // size)
    h0 = min(rank * c, H)
    heads = min(c, H - h0)
    rep = H // G
    if not heads:
        return h0, 0, G - 1, 1
    g0 = h0 // rep
    groups = -(-(h0 + heads) // rep) - g0
    if groups > 1 and (h0 % rep or heads % rep):
        from repro_torch.launch import mesh as mesh_lib

        raise NotImplementedError(
            f"{cfg.name}: model rank {rank} of {size} computes ssm heads {h0}..{h0 + heads - 1}, "
            f"which read {groups} groups of {rep} heads out of step; ssm groups split across "
            f"a rank's heads are {mesh_lib.ROADMAP_SSM_GROUPS}")
    return h0, heads, g0, groups


def _part(tp, leaf, dim: int, whole: int, spans):
    """The rank's `spans` (``(start, stop)`` pairs of the whole leaf's
    indices along `dim`, concatenated) of `leaf`: its own block where that
    is exactly one span; else out of the whole leaf, gathered where it is
    a block (`TP.gather_partial`) and through `TP.copy` where it is
    replicated."""
    n = leaf.shape[dim]
    if n < whole and spans == [(tp.rank * n, (tp.rank + 1) * n)]:
        return leaf, 0
    full = tp.gather_partial(leaf, dim) if n < whole else tp.copy(leaf)
    parts = [full.narrow(dim, a, b - a) for a, b in spans]
    return (parts[0] if len(parts) == 1 else torch.cat(parts, dim)), int(n < whole)


def _layout(params, cfg, tp):
    """``(params, heads, groups)``: the leaves as the rank multiplies them,
    its ssm heads and the groups they read (see the module docstring);
    the whole block without `tp`."""
    if tp is None:
        return params, cfg.ssm_heads, cfg.ssm_groups
    di, N, G, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    H = cfg.ssm_heads
    h0, heads, g0, groups = rank_ssm_heads(cfg, tp.rank, tp.size)
    x_span, grp = (h0 * P, (h0 + heads) * P), (g0 * N, (g0 + groups) * N)
    head_span = (h0, h0 + heads)

    def at(base, span):
        return (base + span[0], base + span[1])

    xbc = [x_span, at(di, grp), at(di + G * N, grp)]
    cut = {
        "in_proj": (-1, 2 * di + 2 * G * N + H,
                    [x_span, at(di, x_span), at(2 * di, grp), at(2 * di + G * N, grp),
                     at(2 * di + 2 * G * N, head_span)]),
        "conv_w": (0, di + 2 * G * N, xbc),
        "conv_b": (0, di + 2 * G * N, xbc),
        "a_log": (0, H, [head_span]),
        "ssm_d": (0, H, [head_span]),
        "dt_bias": (0, H, [head_span]),
        "gnorm": (0, di, [x_span]),
        "out_proj": (0, di, [x_span]),
    }
    p, gathered = {}, 0
    for name, (dim, whole, spans) in cut.items():
        p[name], g = _part(tp, params[name], dim, whole, spans)
        gathered += g
    tp.count_ssm(heads, gathered)
    return p, heads, groups


def _gated_norm(y, z, scale, cfg, tp=None):
    """``rms_norm(y * silu(z), scale)`` over all of ``d_inner``. With `tp`,
    y and z are the rank's channels: the sum of their squares is summed
    over the model ranks in both directions and divided by
    ``cfg.d_inner``, in `rms_norm`'s f32 (f64 for f64)."""
    wide = torch.promote_types(y.dtype, torch.float32)  # f64 for an f64 model
    gated = y * F.silu(z.to(wide)).to(y.dtype)
    if tp is None:
        return rms_norm(gated, scale, cfg.norm_eps)
    v = gated.to(wide)
    ss = tp.copy(tp.reduce(torch.square(v).sum(dim=-1, keepdim=True)))
    out = v * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (out * (1.0 + scale.to(wide))).to(y.dtype)


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


def ssm_block(params, x, cfg, *, chunk_fn=None, tp=None):
    """Full Mamba2 block forward. x (B, S, d) -> (B, S, d).

    The SSD runs through `ssd_forward`; `chunk_fn` replaces its
    intra-chunk step (default: the kernel, with the plain version's
    gradient). `tp`: the rank's own ssm heads (see the module
    docstring; under sequence parallelism x is the rank's positions, and
    so is the output)."""
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    p, H, G = _layout(params, cfg, tp)
    if tp is not None:
        x = tp.enter(x)
    B, S, _ = x.shape
    proj = x @ p["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, cfg, H, G)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs, B_, C_ = _split_xbc(xBC, cfg, H, G)
    xs = xs.reshape(B, S, H, P)
    B_ = B_.reshape(B, S, G, N)
    C_ = C_.reshape(B, S, G, N)
    wide = torch.promote_types(x.dtype, torch.float32)  # f64 for an f64 model
    dt = F.softplus(dt_raw.to(wide) + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    chunk = min(cfg.ssm_chunk, S)
    y = ssd_forward(xs, dt, A, B_, C_, p["ssm_d"], chunk, chunk_fn=chunk_fn)
    y = y.reshape(B, S, H * P)
    y = _gated_norm(y, z, p["gnorm"], cfg, tp)
    out = y @ p["out_proj"]
    return out if tp is None else tp.leave(out)


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) a token)
# ---------------------------------------------------------------------------


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, W - 1, conv_ch): the last inputs of the conv
    h: torch.Tensor  # (B, H, N, P) f32 (f64 for an f64 model)

    @staticmethod
    def init(batch, cfg, dtype, device=None, lead=(), heads=None, groups=None):
        """Zero state, with the leading axes `lead` (a model's stacked
        groups) before the batch; for `heads` ssm heads reading `groups`
        groups (default: all of them; a model rank's from
        `rank_ssm_heads`: its conv channels are its heads' x and its
        groups' B and C, where the reference's cache holds a uniform
        block of ``conv_ch``; both hold the same values for the heads the
        rank computes)."""
        H = cfg.ssm_heads if heads is None else heads
        G = cfg.ssm_groups if groups is None else groups
        conv_ch = H * cfg.ssm_head_dim + 2 * G * cfg.ssm_state
        return SSMState(
            conv=torch.zeros((*lead, batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype,
                             device=device),
            h=torch.zeros((*lead, batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                          dtype=torch.promote_types(dtype, torch.float32), device=device))


def ssm_decode_step(params, x, state: SSMState, cfg, tp=None):
    """x (B, 1, d) -> ``(out (B, 1, d), state)``: the conv history and h
    advanced by one token and written into `state` in place. `tp`: the
    rank's own ssm heads, `state` sized to them."""
    B = x.shape[0]
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    p, H, G = _layout(params, cfg, tp)
    wide = torch.promote_types(x.dtype, torch.float32)  # f64 for an f64 model
    if tp is not None:
        x = tp.copy(x)
    proj = x @ p["in_proj"]
    z, xBC, dt_raw = _split_proj(proj, cfg, H, G)
    hist = torch.cat([state.conv, xBC], dim=1)  # (B, W, ch)
    conv_out = torch.einsum("bwc,cw->bc", hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]  # (B, 1, ch)

    xs, B_, C_ = _split_xbc(conv_out, cfg, H, G)
    xs = xs.reshape(B, H, P)
    rep = H // G
    Bh = torch.repeat_interleave(B_.reshape(B, G, N), rep, dim=1).to(wide)  # (B, H, N)
    Ch = torch.repeat_interleave(C_.reshape(B, G, N), rep, dim=1).to(wide)
    dt = F.softplus(dt_raw[:, 0].to(wide) + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["a_log"])
    a = torch.exp(dt * A[None, :])  # (B, H)

    h = state.h * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dt[..., None], xs.to(wide))
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    y = y + xs.to(wide) * p["ssm_d"][None, :, None]
    y = y.reshape(B, 1, H * P).to(x.dtype)
    y = _gated_norm(y, z, p["gnorm"], cfg, tp)
    state.conv.copy_(hist[:, 1:])
    state.h.copy_(h)
    out = y @ p["out_proj"]
    return (out if tp is None else tp.reduce(out)), state

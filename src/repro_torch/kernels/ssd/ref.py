"""Plain-torch oracle for the SSD intra-chunk kernel (port of
`repro.kernels.ssd.ref`)."""
from __future__ import annotations

import torch


def ssd_chunk_ref(C, B, x, cums, dt):
    """Intra-chunk SSD, one (batch*head, chunk) slice at a time.

    C, B: (BH, nc, Q, N); x: (BH, nc, Q, P); cums, dt: (BH, nc, Q) f32.
    Returns:
      Y (BH, nc, Q, P): intra-chunk output
          Y[i] = sum_{j<=i} exp(cums_i - cums_j) (C_i . B_j) dt_j x_j
      S (BH, nc, N, P): end-of-chunk state contribution
          S = sum_j exp(cums_last - cums_j) dt_j B_j x_j^T

    Also takes the grouped layout of the port's wrapper: C, B (Bb, G,
    nc, Q, N) shared by the H / G heads of each group, x (Bb, H, nc, Q,
    P), cums, dt (Bb, H, nc, Q); Y and S then lead with (Bb, H). The
    mask is applied before the exp (-1e30), as in the reference, so the
    upper triangle neither overflows nor poisons a gradient.
    """
    wide = torch.promote_types(x.dtype, torch.float32)  # f64 for an f64 model
    C, B, x = C.to(wide), B.to(wide), x.to(wide)
    lead = x.shape[:-3]
    if C.dim() == 5:  # grouped: (Bb, G, 1, ...) against (Bb, G, rep, ...)
        bb, g = C.shape[:2]
        rep = x.shape[1] // g  # explicit: a rank without heads passes none
        x = x.reshape(bb, g, rep, *x.shape[2:])
        cums = cums.reshape(bb, g, rep, *cums.shape[2:])
        dt = dt.reshape(bb, g, rep, *dt.shape[2:])
        C, B = C.unsqueeze(2), B.unsqueeze(2)
    Q = C.shape[-2]
    CB = C @ B.transpose(-1, -2)  # (..., Qi, Qj)
    diff = cums[..., :, None] - cums[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=C.device).tril()
    L = torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))
    scores = CB * L * dt[..., None, :]
    Y = scores @ x
    decay_end = torch.exp(cums[..., -1:] - cums) * dt  # (..., Q)
    S = (B * decay_end[..., None]).transpose(-1, -2) @ x
    return Y.reshape(*lead, *Y.shape[-3:]), S.reshape(*lead, *S.shape[-3:])

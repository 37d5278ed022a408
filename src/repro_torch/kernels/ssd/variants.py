"""Variants of the bf16 SSD intra-chunk kernel, to see where its time
goes on the card and how far a fault carries into training.

A variant is ``csrc/ssd_chunk.cu`` with the named edits of `EDITS`
applied, several joined by ``+``; ``kernel`` is the source unchanged.
Most of them compute wrong results on purpose and serve only to time a
part of the kernel: ``staging-only`` returns after staging B, X, C and
the decays, ``no-S`` after Y, ``no-Y`` skips Y, ``empty`` returns
before staging, ``no-stores`` drops the stores of Y and S, ``no-B``,
``no-X`` and ``no-C`` skip one input's staging. ``one-term`` and
``two-term`` multiply only the first one or two bf16 terms of each
split: a planted fault (about 2^-9 and 2^-17 of each operand) for the
trainer-path comparison. ``one-chain`` (C B^T summed in one chain over
N, as first written) and ``8-warps`` keep the arithmetic and are held
to `ssd_chunk_ref` like the kernel itself.

An edit is an exact (old text, new text) pair of the source; every edit
must find its text (`variant_source` raises otherwise, and a CPU test
applies all of them). `build_variants` builds through
`repro_torch.kernels.build`; ``chip_smoke.py --ssd-variants`` times
them and ``chip_smoke.py --trainer-controls`` trains through them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops

Y_PHASE = "  // ---------------- Y, row tiles in snake order"
S_PHASE = "  // ---------------- S, row tiles of n round-robin"
STAGE_B = "  stage(b_sh, ldb, Bz,"
STAGE_X = "  stage(x_sh, TC_LDX, Xz,"
STAGE_C = "  if (warp < row_tiles)  // the warp"
SPLIT = "for (int t = 0; t < 3; ++t) {"
CB_LOOP = """        for (int k0 = 0; k0 < np; k0 += 32) {
          cb_step(sc[0], sc[1], cw, b_sh + j0 * ldb, ldb, k0, lane);
          if (k0 + 16 < np) cb_step(sc[2], sc[3], cw, b_sh + j0 * ldb, ldb, k0 + 16, lane);
        }"""
# name -> [(text of the source, its replacement)]
EDITS = {
    "one-chain": [(CB_LOOP, "        for (int k0 = 0; k0 < np; k0 += 16)\n"
                            "          cb_step(sc[0], sc[1], cw, b_sh + j0 * ldb, ldb, k0, lane);")],
    "8-warps": [("constexpr int TC_WARPS = 4;", "constexpr int TC_WARPS = 8;")],
    "empty": [(STAGE_B, "  if (Q > 0) return;\n" + STAGE_B)],
    "staging-only": [(Y_PHASE, "  if (Q > 0) return;\n" + Y_PHASE)],
    "no-S": [(S_PHASE, "  if (Q > 0) return;\n" + S_PHASE)],
    "no-Y": [("for (int base = 0; base < row_tiles;", "for (int base = row_tiles; base < row_tiles;")],
    "no-B": [(STAGE_B, "  if (Q < 0) " + STAGE_B.strip())],
    "no-X": [(STAGE_X, "  if (Q < 0) " + STAGE_X.strip())],
    "no-C": [(STAGE_C, "  if (Q < 0 && warp < row_tiles)  // the warp")],
    "no-stores": [("if (ra) store2", "if (Q < 0) store2"), ("if (rb) store2", "if (Q < 0) store2"),
                  ("if (na < N) store2", "if (Q < 0) store2"),
                  ("if (nb < N) store2", "if (Q < 0) store2")],
    "one-term": [(SPLIT, SPLIT.replace("3", "1"))],
    "two-term": [(SPLIT, SPLIT.replace("3", "2"))],
}
EXACT = {"kernel", "one-chain", "8-warps"}
DEFAULT = ["kernel", "one-chain", "8-warps", "no-S", "no-Y", "staging-only", "empty",
           "staging-only+no-B", "staging-only+no-X", "staging-only+no-C", "no-stores",
           "one-term"]


def variant_source(name: str) -> str:
    """The text of ``csrc/ssd_chunk.cu`` with variant `name`'s edits."""
    source = build.source_path("ssd_chunk").read_text()
    for edit in ([] if name == "kernel" else name.split("+")):
        for old, new in EDITS[edit]:
            if old not in source:
                raise ValueError(f"edit {edit!r}: {old!r} is not in the kernel source")
            source = source.replace(old, new)
    return source


def build_variants(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """name -> the variant's library, bound for `ops.launch`; every nvcc
    started together (ptxas reports beside the libraries, as `build`)."""
    paths = build.build((), texts={f"ssd_chunk-{n}": variant_source(n) for n in names})
    return {n: ops.bind(ctypes.CDLL(str(paths[f"ssd_chunk-{n}"]))) for n in names}


def chunk_fn(lib: ctypes.CDLL):
    """A trainer's ``chunk_fn`` as `ops.ssd_chunk_autograd`, with the
    forward of variant `lib`: its gradient is `ssd_chunk_ref`'s."""

    class Variant(ops.SSDChunk):
        @staticmethod
        def forward(ctx, C, B, x, cums, dt):
            ctx.save_for_backward(C, B, x, cums, dt)
            return ops.launch(lib, C, B, x, cums, dt)

    return Variant.apply

"""Variants of the gossip drain, enqueue and mix kernels, to see where
their time goes on the card.

A variant of kernel ``drain``, ``enqueue`` or ``mix`` is ``csrc/<kernel>.cu``
with the named edits of ``EDITS[kernel]`` applied, several joined by
``+``; ``kernel`` is the source unchanged, and ``baseline`` is the same
kernel's source from another tree (a previous design, say the parent
commit unpacked), with that tree's shared header, built beside it. Some
edits compute wrong results on purpose and serve only to time a part of
the kernel: ``empty`` returns
on entry (an empty launch of the persistent grid), ``staging-only``
stages the weights and streams the payload ring with no FMAs and no
stores, ``no-fma`` streams the ring and stores without the FMAs,
``no-stores`` drops the stores only, ``compute-only`` copies no payload
(each stage keeps its row offsets) and times the product and the
stores, ``one-term`` keeps one split term of the tensor-core
product, and ``wide-no-mma`` and ``wide-no-copy`` drop the wide route's
product or its copies. The others keep the arithmetic and are held to the plain
version like the kernel itself: ``stages-1`` to ``stages-4`` set the
ring's depth, and ``cuda-cores`` (the drain) or ``tensor-cores`` (the
enqueue) takes the kernel's other product. The mix has its own edits
(``MIX``): ``empty``, ``no-fma`` (no product: a sum in the narrow route's,
no wgmma in the tensor route's), ``no-stores``, ``staging-only``,
``one-term`` and ``no-copy`` (the tensor route's), and shapes that keep
the arithmetic: ``narrow-ch-double`` and ``narrow-ch-half`` (twice and
half the loads in flight in the narrow route). A name that does not
apply to a kernel is skipped for it (`applies`).

An edit is an exact (old text, new text) pair of the source; every edit
must find its text (`variant_source` raises otherwise, and a CPU test
applies all of them). `build_variants` builds through
`repro_torch.kernels.build`; ``chip_smoke.py --gossip-variants`` times
them at the main path's shapes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch.kernels import build
from repro_torch.kernels.gossip import ops

ENTRY = "  extern __shared__ __align__(16) unsigned char smem[];"
STAGES = "constexpr int STAGES = 3;"
PRODUCT = "constexpr bool TENSOR_CORES = "
INCLUDE = '#include "stream.cuh"'
# the product's call, on the CUDA cores and on the tensor cores
FMA = [("accumulate(acc, ring_sh", "if (K < 0) accumulate(acc, ring_sh"),
       ("accumulate_tc(c, ring_sh", "if (K < 0) accumulate_tc(c, ring_sh")]


def _set(text: str, n: int) -> list:
    return [(text, text.replace(text.split()[-1], f"{n};"))]


_COMMON = {
    "empty": [(ENTRY, "  if (K > 0) return;\n" + ENTRY)],
    "no-fma": FMA,
    # no payload copies (the producer still posts each stage and its row
    # offsets): the product and the stores alone
    "compute-only": [("bytes = __reduce_add_sync(0xffffffffu, bytes);", "bytes = 0;")],
    # the tensor-core product with its first split term only (wrong by ~2^-11)
    "one-term": [("        mma_tf32(c[mt][q], al, bh[q][0], bh[q][1]);\n"
                  "        if constexpr (sizeof(T) == 4) mma_tf32(c[mt][q], ah, bl[q][0], bl[q][1]);\n",
                  "")],
}
# the wide route (stream.cuh's wide_kernel): no product, no payload or
# weight copies (each stage still arrives)
_COMMON.update({
    "wide-no-mma": [("      accumulate_wide(c, p_sh", "      if (K < 0) accumulate_wide(c, p_sh")],
    "wide-no-copy": [("    if (c < chunks) cp_async16(",
                      "    if (cols < 0 && c < chunks) cp_async16(")],
    "wide-no-issue": [("    if (v < total) {\n", "    if (v < total && K < 0) {\n")],
    "wide-no-store": [("      store_tc(c, wbuf, gm, (int)min((long long)32, K - c0 - 32 * warp),",
                       "      if (K < 0) store_tc(c, wbuf, gm, (int)min((long long)32, "
                       "K - c0 - 32 * warp),")],
    "wide-no-scan": [("unit_sh[i] = a.skip ? 0 : 1;", "unit_sh[i] = 1;"),
                     ("  if (a.skip) {  // flag", "  if (K < 0) {  // flag")],
})
_TC_STORES = [("store_tc(c, buf", "if (K < 0) store_tc(c, buf")]
_STORES = {"drain": [("if (m < M && col < cols) out_r[",
                       "if (K < 0 && m < M && col < cols) out_r[")]
           + _TC_STORES,
           "enqueue": [("if (m < N && col < cols)", "if (K < 0 && m < N && col < cols)")]
           + _TC_STORES}
# each kernel's other product: the drain runs on the tensor cores, the
# enqueue on the CUDA cores (each the faster of the two on an H100, PERF.md)
_OTHER = {"drain": ("cuda-cores", [(PRODUCT + "true;", PRODUCT + "false;")]),
          "enqueue": ("tensor-cores", [(PRODUCT + "false;", PRODUCT + "true;")])}
# kernel -> edit name -> [(text of the source, its replacement)]
EDITS = {k: dict(_COMMON, **{"no-stores": stores, "staging-only": FMA + stores,
                             _OTHER[k][0]: _OTHER[k][1]})
         for k, stores in _STORES.items()}
for _k in EDITS:  # the ring's depth
    EDITS[_k].update({f"stages-{n}": _set(STAGES, n) for n in (1, 2, 4)})

# the mix (csrc/mix.cu): its narrow route's product (the loads kept live by
# a sum in its place) and stores, its tensor route's product, stores and
# copies (behind tests the compiler cannot settle), and shapes that keep
# the arithmetic
_MIX_FMA = [("if (n0 + j < N) narrow_fma<NR, C>(acc, q_sh + (n0 + j) * NR, p[j]);",
             "if (n0 + j < N) for (int i = 0; i < C; ++i) acc[0][i] += p[j][i];"),
            ("    tensor_mma<T, NB>(acc, ring", "    if (K >> 62) tensor_mma<T, NB>(acc, ring")]
_MIX_STORES = [("      if (m < N) {\n        T* orow", "      if ((K >> 62) && m < N) {\n        T* orow"),
               ("      tensor_store<T, NB>(acc, buf", "      if (K >> 62) tensor_store<T, NB>(acc, buf")]
MIX = {
    "empty": [("if (K < 1) return;  // nothing to mix", "return;  // nothing to mix")],
    "no-fma": _MIX_FMA,
    "no-stores": _MIX_STORES,
    "staging-only": _MIX_FMA + _MIX_STORES,
    # the tensor route's product with its hi x hi term only (wrong by ~2^-11)
    "one-term": [("        if constexpr (sizeof(T) == 4) wgmma_tf32(acc[b], al[ks], dh);\n"
                  "        wgmma_tf32(acc[b], ah[ks], dl);\n", "")],
    "no-copy": [("if (ch < (int)((head + bytes + 15) >> 4))",
                 "if ((K >> 62) && ch < (int)((head + bytes + 15) >> 4))")],
    "narrow-ch-double": [("return 16 / C;", "return 32 / C;")],
    "narrow-ch-half": [("return 16 / C;", "return 8 / C;")],
}
EDITS["mix"] = MIX

# variants that compute the kernel's function
EXACT = {"kernel", "baseline", "stages-1", "stages-2", "stages-4", "cuda-cores",
         "tensor-cores", "narrow-ch-double", "narrow-ch-half"}
DEFAULT = ["kernel", "cuda-cores", "tensor-cores", "empty", "staging-only", "no-fma",
           "no-stores", "compute-only", "one-term", "no-copy", "stages-1", "stages-2",
           "stages-4", "narrow-ch-double", "narrow-ch-half"]
BIND = {"drain": ops.bind_drain, "enqueue": ops.bind_enqueue, "mix": ops.bind_mix}
KERNELS = tuple(BIND)


def applies(kernel: str, name: str) -> bool:
    """Whether variant `name` (edits joined by ``+``) exists for `kernel`."""
    return name in ("kernel", "baseline") or all(e in EDITS[kernel] for e in name.split("+"))


def variant_source(kernel: str, name: str, baseline: Optional[Path] = None) -> str:
    """The text of ``csrc/<kernel>.cu`` with variant `name`'s edits (the
    shared header inlined, so that edits may reach into it); ``baseline``
    is the file of the same name under the tree `baseline`."""
    if name == "baseline":
        if baseline is None:
            raise ValueError("the baseline variant needs a tree to take the source from")
        path = Path(baseline) / "src" / "repro_torch" / "kernels" / build.SOURCES[kernel]
        source, header = path.read_text(), path.with_name("stream.cuh")
        if INCLUDE in source and header.exists():  # that tree's header, not this one's
            source = source.replace(INCLUDE, header.read_text().replace("#pragma once\n", ""))
        return source
    source = build.source_path(kernel).read_text()
    if name != "kernel":
        header = build.source_path(kernel).with_name("stream.cuh").read_text()
        source = source.replace(INCLUDE, header.replace("#pragma once\n", ""))
    for edit in ([] if name == "kernel" else name.split("+")):
        for old, new in EDITS[kernel][edit]:  # every occurrence
            if old not in source:
                raise ValueError(f"{kernel} edit {edit!r}: {old!r} is not in the kernel source")
            source = source.replace(old, new)
    return source


def build_variants(names: Sequence[str], baseline: Optional[Path] = None,
                   kernels: Sequence[str] = KERNELS,
                   ) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """kernel -> name -> the variant's library, bound for
    ``ops.launch_<kernel>``, for each name that `applies` to the kernel;
    every nvcc started together (ptxas reports beside the libraries)."""
    wanted = [(k, n) for k in kernels for n in names if applies(k, n)]
    paths = build.build((), texts={f"{k}-{n}": variant_source(k, n, baseline) for k, n in wanted})
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {k: {} for k in kernels}
    for k, n in wanted:
        libs[k][n] = BIND[k](ctypes.CDLL(str(paths[f"{k}-{n}"])))
    return libs

"""TF32-ON: TF32 stays off, in the port and in its tests.

The port's f32 products must run in full f32, as the reference does on
the CPU: its parity tests hold GEMM paths to f32 ``1e-5`` and importing
`repro_torch` switches TF32 off for cuBLAS and cuDNN. A line that turns
it back on (``torch.backends.cuda.matmul.allow_tf32 = True``,
``torch.backends.cudnn.allow_tf32 = True``,
``torch.set_float32_matmul_precision("high")`` or ``"medium"``) would
loosen every product after it, in whatever module runs next. A kernel
that uses the TF32 tensor cores on purpose does so in its own source,
with its own split (``csrc/mix.cu``'s split-TF32 route).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import Finding, SourceFile, register_rule
from repro_torch.analysis.hotctx import dotted

RULE = "TF32-ON"


@register_rule(
    RULE,
    "allow_tf32 = True or set_float32_matmul_precision('high'/'medium'): TF32 "
    "loosens every f32 product after it")
def check_tf32(src: SourceFile) -> Iterator[Finding]:
    if src.tree is None:
        return
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            on = isinstance(node.value, ast.Constant) and node.value.value is True
            for t in targets:
                d = dotted(t)
                if on and d is not None and d[-1] == "allow_tf32":
                    yield src.finding(RULE, node,
                                      f"{'.'.join(d)} = True switches TF32 on")
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is not None and d[-1] == "set_float32_matmul_precision" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value in ("high", "medium"):
                yield src.finding(
                    RULE, node,
                    f"set_float32_matmul_precision({node.args[0].value!r}) lets f32 "
                    "matmuls run in TF32")

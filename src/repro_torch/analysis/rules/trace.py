"""TENSOR-PY-BRANCH and HOST-SYNC-IN-HOT-PATH (the counterparts of the
reference's TRACED-PY-BRANCH and HOST-SYNC-IN-JIT).

Both rules share one machine: `hotctx.FunctionIndex` decides which
functions are hot contexts (the seeded entry points and what they call
in their module), and `tensorness.TensorWalker` walks each context
forward, flagging Python control flow ("branch") and device->host reads
("host-sync") on tensors. On the card either one drains the stream: the
host waits for every queued kernel, and a CUDA graph cannot capture the
loop (ROADMAP item 15). A read that a path needs by design carries a
suppression with its reason.
"""
from __future__ import annotations

from typing import Iterator, Set, Tuple

from repro_torch.analysis.core import Finding, SourceFile, register_rule
from repro_torch.analysis.hotctx import FunctionIndex
from repro_torch.analysis.tensorness import analyze_function

_BRANCH = "TENSOR-PY-BRANCH"
_SYNC = "HOST-SYNC-IN-HOT-PATH"


def _hazards(src: SourceFile) -> Iterator[Tuple[str, object, str, str]]:
    """(kind, node, detail, origin) across every hot context, deduped by
    (kind, line, col): nested defs are walked both as closures of their
    parent and as contexts of their own."""
    if src.tree is None:
        return
    index = FunctionIndex(src.tree, src.path)
    seen: Set[Tuple[str, int, int]] = set()
    for ctx in index.hot_contexts():
        walker = analyze_function(ctx.func, ctx.tensor_params)
        for kind, node, detail in walker.hazards:
            key = (kind, node.lineno, node.col_offset)
            if key in seen:
                continue
            seen.add(key)
            yield kind, node, detail, ctx.origin


@register_rule(
    _BRANCH,
    "Python if/while/assert/bool()/ternary on a tensor inside a hot path "
    "(window, round, event, decode and train steps)")
def check_tensor_branch(src: SourceFile) -> Iterator[Finding]:
    for kind, node, detail, origin in _hazards(src):
        if kind == "branch":
            yield src.finding(_BRANCH, node, f"{detail} [{origin}]")


@register_rule(
    _SYNC,
    "float()/int()/.item()/.tolist()/.cpu()/.numpy()/np.asarray on a tensor "
    "inside a hot path (device->host sync)")
def check_host_sync(src: SourceFile) -> Iterator[Finding]:
    for kind, node, detail, origin in _hazards(src):
        if kind == "host-sync":
            yield src.finding(_SYNC, node, f"{detail} [{origin}]")

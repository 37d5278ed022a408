"""DTYPE-PLANE-CONTRACT: the shape planes must stay documented.

The whole engine moves data through a fixed set of named planes —
``(N, Dflat)`` client flats, ``(D, N, Dflat)`` delay ring payloads,
``(D, N, N)`` weight/delay rings, ``(N, Dopt)`` optimizer slabs,
``(S, N, K)`` / ``(J, N, M)`` sharded gossip buffers. Public functions
in `core/flat.py`, `core/protocol.py`, `events/*`, `kernels/gossip/*`
that take one of these plane parameters must carry a docstring that
names the parameter next to its shape tuple, and the documented shape
must be one of the contracts below — a mismatch means either the doc or
the code drifted.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, Set

from repro_torch.analysis.core import Finding, SourceFile, register_rule

RULE = "DTYPE-PLANE-CONTRACT"

# Directories/files the contract applies to (path fragments, / separated):
# the port's own
_SCOPE = ("repro_torch/core/flat.py", "repro_torch/core/protocol.py",
          "repro_torch/events/", "repro_torch/kernels/gossip/")

# plane param name -> allowed documented shapes (whitespace-insensitive)
PLANE_PARAMS: Dict[str, Set[str]] = {
    "flat": {"(N,Dflat)", "(Dflat,)"},
    "flats": {"(N,Dflat)"},
    "pending": {"(N,Dflat)", "(N,K)", "(N,...)"},
    "deltas": {"(N,Dflat)", "(N,K)"},
    "buffer": {"(D,N,Dflat)", "(D,N,...)"},
    "ring": {"(D,N,Dflat)", "(S,N,K)"},
    "w_ring": {"(D,N,N)"},
    "delay_ring": {"(D,N,N)"},
    "deadline_ring": {"(D,N,N)"},
    "w_stack": {"(D,N,N)", "(J,N,N)", "(J,N,M)"},
    "opt_state": {"(N,Dopt)"},
    "q": {"(N,N)"},
}

_SHAPE_RE_TMPL = r"\b{name}\b[^()]{{0,60}}\(([^()]*)\)"


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(frag in p for frag in _SCOPE)


def _documented_shapes(doc: str, name: str) -> list:
    """Every `(...)` tuple documented within reach of a `name` mention —
    a docstring passes if *any* of them matches the contract (prose may
    mention the param before the annotated line does)."""
    pat = _SHAPE_RE_TMPL.format(name=re.escape(name))
    return ["(" + re.sub(r"\s+", "", m.group(1)) + ")"
            for m in re.finditer(pat, doc)]


def _public_functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not stmt.name.startswith("_"):
            yield stmt


@register_rule(
    RULE,
    "public plane-carrying functions in core/flat, core/protocol, events/*, "
    "kernels/gossip/* must docstring-annotate (N, Dflat)/(D, N, Dflat)/"
    "(D, N, N) shapes; documented shapes must match the contract table")
def check_plane_contracts(src: SourceFile) -> Iterator[Finding]:
    if src.tree is None or not _in_scope(src.path):
        return
    for func in _public_functions(src.tree):
        a = func.args
        params = [p.arg for p in (list(a.posonlyargs) + list(a.args)
                                  + list(a.kwonlyargs))]
        plane_params = [p for p in params if p in PLANE_PARAMS]
        if not plane_params:
            continue
        doc = ast.get_docstring(func, clean=True)
        if not doc:
            yield src.finding(
                RULE, func,
                f"public '{func.name}' takes plane param(s) "
                f"{', '.join(plane_params)} but has no shape-contract "
                "docstring")
            continue
        for p in plane_params:
            shapes = _documented_shapes(doc, p)
            if not shapes:
                yield src.finding(
                    RULE, func,
                    f"docstring of '{func.name}' does not annotate the "
                    f"shape of plane param '{p}' — document it as one of "
                    f"{sorted(PLANE_PARAMS[p])}")
            elif not any(s in PLANE_PARAMS[p] for s in shapes):
                yield src.finding(
                    RULE, func,
                    f"docstring of '{func.name}' documents '{p}' as "
                    f"{shapes[0]}, but the plane contract allows "
                    f"{sorted(PLANE_PARAMS[p])} — doc or code drifted")

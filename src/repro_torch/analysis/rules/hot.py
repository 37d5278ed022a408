"""HOST-CONSTANT-IN-HOT-PATH and KERNEL-BUILD-IN-LOOP (the counterparts
of the reference's JIT-RECOMPILE-HAZARD).

The reference's rule has three sub-patterns. Two carry over to eager
torch:

* its sub-pattern 3, a jitted function closing over a module-level
  numpy array, becomes HOST-CONSTANT-IN-HOT-PATH: a hot context (see
  `hotctx`) that reads a module-level ``np.array(...)``-style constant
  copies it from host memory to the card on every call (a synchronous
  copy from pageable memory). Make the tensor once, on the device, and
  pass it in. A *warning*: a cost, not a bug, so it gates under
  ``--strict``;
* its sub-pattern 2, ``jax.jit`` called per invocation or inside a
  loop, becomes KERNEL-BUILD-IN-LOOP: `repro_torch.kernels.build`'s
  ``build`` or ``load`` (nvcc, then ``dlopen``) called inside a
  ``for``/``while`` body. The wrappers bind each library once
  (``functools.lru_cache``); a build belongs before the loop.

Its sub-pattern 1, unhashable jit arguments outside
``static_argnames``, has no torch meaning: an eager call has no compile
cache to key.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Set

from repro_torch.analysis.core import Finding, SourceFile, register_rule
from repro_torch.analysis.hotctx import FunctionIndex, dotted

CONSTANT = "HOST-CONSTANT-IN-HOT-PATH"
BUILD = "KERNEL-BUILD-IN-LOOP"

_ARRAY_MAKERS = {"array", "asarray", "ones", "zeros", "arange", "linspace",
                 "eye", "full", "empty", "identity"}
_ARRAY_ROOTS = {"np", "numpy", "onp"}
_BUILDERS = {"build", "load"}


def _module_array_constants(tree: ast.Module) -> Dict[str, int]:
    """name -> lineno of module-level `X = np.array(...)`-style binds."""
    consts: Dict[str, int] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or not isinstance(stmt.value, ast.Call):
            continue
        d = dotted(stmt.value.func)
        if d is None or len(d) < 2 or d[0] not in _ARRAY_ROOTS \
                or d[-1] not in _ARRAY_MAKERS:
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                consts[t.id] = stmt.lineno
    return consts


@register_rule(
    CONSTANT,
    "a hot path reads a module-level numpy array constant: copied host->device "
    "on every call (make the tensor once and pass it in)")
def check_host_constants(src: SourceFile) -> Iterator[Finding]:
    if src.tree is None:
        return
    consts = _module_array_constants(src.tree)
    if not consts:
        return
    for ctx in FunctionIndex(src.tree, src.path).hot_contexts():
        params = {p.arg for p in (list(ctx.func.args.posonlyargs)
                                  + list(ctx.func.args.args)
                                  + list(ctx.func.args.kwonlyargs))}
        seen: Set[str] = set()
        for node in ast.walk(ctx.func):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in consts and node.id not in params \
                    and node.id not in seen:
                seen.add(node.id)
                yield src.finding(
                    CONSTANT, node,
                    f"'{ctx.func.name}' ({ctx.origin}) reads module-level array "
                    f"constant '{node.id}' (bound at line {consts[node.id]}); it is "
                    "copied to the device on every call: make it a device tensor "
                    "once and pass it in", severity="warning")


def _is_build_call(call: ast.Call) -> bool:
    d = dotted(call.func)
    return d is not None and len(d) >= 2 and d[-2] == "build" and d[-1] in _BUILDERS


@register_rule(
    BUILD,
    "kernels.build's build/load (nvcc, dlopen) called inside a for/while body; "
    "build and bind once, before the loop")
def check_build_in_loop(src: SourceFile) -> Iterator[Finding]:
    if src.tree is None:
        return
    flagged: Set[int] = set()
    for node in ast.walk(src.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        for sub in ast.walk(node):
            if sub is not node and isinstance(sub, ast.Call) and _is_build_call(sub) \
                    and id(sub) not in flagged:
                flagged.add(id(sub))
                yield src.finding(
                    BUILD, sub,
                    f"{'.'.join(dotted(sub.func))}() inside a loop body builds or "
                    "loads a kernel library per iteration; build it once before "
                    "the loop")

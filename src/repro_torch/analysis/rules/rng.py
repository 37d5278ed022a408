"""RNG-GENERATOR: every draw of the port from an explicit generator, and
no two generators from one seed (the counterpart of the reference's
RNG-KEY-REUSE).

The port's runs are reproducible, and its parity tests can inject the
reference's draws, because every random draw takes the run's
`torch.Generator` (`repro_torch.as_generator`) and never the global
default generator. Two findings, in `src/repro_torch` only:

* a draw (`torch.rand`, `randn`, `randint`, `randperm`, `*_like`,
  `normal`, `bernoulli`, `multinomial`, `poisson`, and the in-place
  `.normal_()`, `.uniform_()`, `.bernoulli_()`, `.exponential_()`,
  `.random_()`, ...) without a ``generator=`` keyword;
* two generators seeded from the same expression in one function
  (``torch.Generator(...).manual_seed(s)``, ``g.manual_seed(s)``,
  ``as_generator(s, ...)``): two streams that draw the same numbers, the
  analogue of one key feeding two consumers.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator

from repro_torch.analysis.core import Finding, SourceFile, register_rule
from repro_torch.analysis.hotctx import dotted

RULE = "RNG-GENERATOR"

_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
                "randint_like", "normal", "bernoulli", "multinomial", "poisson"}
_METHOD_DRAWS = {"normal_", "uniform_", "bernoulli_", "exponential_", "geometric_",
                 "log_normal_", "cauchy_", "random_"}
_SEEDERS = {"manual_seed", "as_generator"}


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return "repro_torch/" in p and "/tests/" not in p


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" or kw.arg is None for kw in call.keywords)


def _draw_name(call: ast.Call):
    d = dotted(call.func)
    if d is not None and len(d) >= 2 and d[0] == "torch" and d[-1] in _TORCH_DRAWS:
        return ".".join(d)
    if isinstance(call.func, ast.Attribute) and call.func.attr in _METHOD_DRAWS:
        return "." + call.func.attr
    return None


def _seed_expr(call: ast.Call):
    """The seed expression of a generator-seeding call, or None."""
    d = dotted(call.func)
    name = call.func.attr if isinstance(call.func, ast.Attribute) else (
        d[-1] if d else None)
    if name not in _SEEDERS or not call.args:
        return None
    if name == "manual_seed" and d is not None and d[0] == "torch":
        return None  # torch.manual_seed seeds the global generator, not a stream
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and arg.value is None:
        return None
    return ast.dump(arg)


@register_rule(
    RULE,
    "a random draw in src/repro_torch without generator=, or two generators "
    "seeded from the same expression in one function (identical streams)")
def check_generators(src: SourceFile) -> Iterator[Finding]:
    if src.tree is None or not _in_scope(src.path):
        return
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            name = _draw_name(node)
            if name is not None and not _has_generator(node):
                yield src.finding(
                    RULE, node,
                    f"{name}() draws from the global default generator; pass the "
                    "run's generator= (repro_torch.as_generator)")
    funcs = [n for n in ast.walk(src.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for func in funcs:
        seeded: Dict[str, int] = {}
        calls = sorted((n for n in _own_nodes(func) if isinstance(n, ast.Call)),
                       key=lambda n: (n.lineno, n.col_offset))
        for node in calls:
            key = _seed_expr(node)
            if key is None:
                continue
            if key in seeded:
                yield src.finding(
                    RULE, node,
                    f"a second generator seeded from the expression seeded at line "
                    f"{seeded[key]}: both streams draw the same numbers; derive "
                    "distinct seeds")
            else:
                seeded[key] = node.lineno


def _own_nodes(func) -> Iterator[ast.AST]:
    """Nodes of `func`'s body, not of the functions nested in it."""
    stack = list(func.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))

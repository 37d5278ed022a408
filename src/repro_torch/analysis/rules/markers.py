"""MARKER-DISCIPLINE: heavy test batteries must be marked ``slow``.

ROADMAP tiering keeps tier-1 (`pytest -m "not slow"`) at ~2 minutes.
Two patterns must therefore carry ``@pytest.mark.slow`` (per test) or a
module-level ``pytestmark = pytest.mark.slow``:

* test *files* whose names match the battery patterns
  (parity / mesh / theory / property / system / dryrun);
* hypothesis tests (any ``@given``-decorated test), which multiply
  their body by the example count.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, Set

from repro_torch.analysis.core import Finding, SourceFile, register_rule
from repro_torch.analysis.hotctx import dotted

RULE = "MARKER-DISCIPLINE"

SLOW_FILE_PATTERNS = re.compile(
    r"test_.*(parity|mesh|theory|property|system|dryrun)")


def _is_test_file(path: str) -> bool:
    p = path.replace("\\", "/")
    return "tests/" in p and os.path.basename(p).startswith("test_")


def _has_module_slow_mark(tree: ast.Module) -> bool:
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            names = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            if "pytestmark" in names and "slow" in ast.dump(stmt.value):
                return True
    return False


def _decorator_names(func: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for deco in func.decorator_list:
        node = deco.func if isinstance(deco, ast.Call) else deco
        d = dotted(node)
        if d is not None:
            out.add(".".join(d))
    return out


def _test_functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and stmt.name.startswith("test"):
            yield stmt
        elif isinstance(stmt, ast.ClassDef) and stmt.name.startswith("Test"):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and sub.name.startswith("test"):
                    yield sub


@register_rule(
    RULE,
    "parity/mesh/theory/property/system battery files and @given "
    "(hypothesis) tests must carry @pytest.mark.slow so tier-1 stays fast")
def check_marker_discipline(src: SourceFile) -> Iterator[Finding]:
    if src.tree is None or not _is_test_file(src.path):
        return
    if _has_module_slow_mark(src.tree):
        return
    basename = os.path.basename(src.path)
    battery = SLOW_FILE_PATTERNS.search(basename) is not None
    for func in _test_functions(src.tree):
        decos = _decorator_names(func)
        slow = any(d.endswith("mark.slow") or d == "slow" for d in decos)
        if slow:
            continue
        hypothesis = any(d == "given" or d.endswith(".given")
                         for d in decos)
        if battery:
            yield src.finding(
                RULE, func,
                f"'{func.name}' in battery file {basename} lacks "
                "@pytest.mark.slow (add it, or a module-level pytestmark)")
        elif hypothesis:
            yield src.finding(
                RULE, func,
                f"hypothesis test '{func.name}' (@given) lacks "
                "@pytest.mark.slow — example sweeps don't belong in tier-1")

"""Forward tensor-name propagation through one function body (the torch
counterpart of `repro.analysis.tensorness`).

Given a function and the set of its tensor params (from
`repro_torch.analysis.hotctx`), a single in-order pass tracks which
local names (may) hold tensors and emits *hazard records* along the
way:

    ("branch",    node, detail)  Python `if`/`while`/`assert`/ternary/
                                 `bool()` on a tensor: the host waits
                                 for the device to read the value, and
                                 a CUDA graph cannot capture the branch.
    ("host-sync", node, detail)  `float()`/`int()`/`.item()`/
                                 `.tolist()`/`.cpu()`/`.numpy()`/
                                 `np.asarray` on a tensor: a
                                 device->host copy that drains the
                                 stream.

The pass is flow-ordered but intentionally simple: loops are walked
twice (to catch loop-carried tensors), `if` branches are walked
independently and their outcomes unioned, and nested `def`s are walked
with the enclosing tensor set added (a closure captures its tensors).
Host-value exemptions live in `hotctx` — see its docstring.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from repro_torch.analysis.hotctx import (
    STATIC_ATTRS,
    STRUCTURAL_CALLS,
    _default_static_params,
    _param_names,
    dotted,
)

_NP_ROOTS = {"np", "numpy", "onp"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


class TensorWalker:
    def __init__(self, func: ast.FunctionDef, tensor_params: Set[str]):
        self.func = func
        self.hazards: List[Tuple[str, ast.AST, str]] = []
        self.calls: List[Tuple[ast.Call, Dict[int, bool]]] = []
        static = _default_static_params(func)
        self.tensor: Set[str] = set(tensor_params) - static

    def run(self) -> "TensorWalker":
        self.visit_block(self.func.body)
        return self

    # -- expressions --------------------------------------------------------

    def is_tensor(self, node: ast.AST) -> bool:
        """Does evaluating `node` touch a tensor value? (Also records
        hazards and call-argument tensorness as side effects.)"""
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tensor
        if isinstance(node, ast.Attribute):
            # host metadata at any link of the chain (`x[0].shape`, too)
            if node.attr in STATIC_ATTRS:
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value) | self.is_tensor(node.slice)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False  # identity tests are structural
            t = self.is_tensor(node.left)
            for c in node.comparators:
                t |= self.is_tensor(c)
            return t
        if isinstance(node, ast.Call):
            return self._visit_call(node)
        if isinstance(node, ast.IfExp):
            if self.is_tensor(node.test):
                self.hazards.append((
                    "branch", node.test,
                    "ternary `a if cond else b` on a tensor (a device sync)"))
            return self.is_tensor(node.body) | self.is_tensor(node.orelse)
        if isinstance(node, ast.Lambda):
            return False  # a lambda *expression* is a static callable
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            t = False
            for gen in node.generators:
                t |= self.is_tensor(gen.iter)
                for cond in gen.ifs:
                    t |= self.is_tensor(cond)
            if isinstance(node, ast.DictComp):
                t |= self.is_tensor(node.key) | self.is_tensor(node.value)
            else:
                t |= self.is_tensor(node.elt)
            return t
        t = False
        for child in ast.iter_child_nodes(node):
            t |= self.is_tensor(child)
        return t

    def _visit_call(self, node: ast.Call) -> bool:
        d = dotted(node.func)
        name = d[-1] if d else None
        root = d[0] if d else None

        arg_tensor: Dict[int, bool] = {}
        any_tensor = False
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            inner = arg.value if isinstance(arg, ast.Starred) else arg
            t = self.is_tensor(inner)
            arg_tensor[id(arg)] = t
            any_tensor |= t
        if d is not None and len(d) == 1:
            self.calls.append((node, arg_tensor))

        if name in STRUCTURAL_CALLS and root == name:
            return False  # isinstance/len/hasattr/...: structural reads

        first = node.args[0] if node.args else None
        first_tensor = first is not None and arg_tensor.get(id(first), False)
        if root == name == "bool" and first_tensor:
            self.hazards.append((
                "branch", node, "bool() on a tensor reads its value on the "
                "host (a device sync)"))
            return False
        elif root == name in {"float", "int"} and first_tensor:
            self.hazards.append((
                "host-sync", node,
                f"{name}() on a tensor forces a device->host sync"))
            return False
        elif d is not None and len(d) >= 2 and root in _NP_ROOTS \
                and name in {"asarray", "array"} and first_tensor:
            self.hazards.append((
                "host-sync", node,
                f"{root}.{name}() on a tensor pulls it to host memory"))
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HOST_SYNC_METHODS \
                and self.is_tensor(node.func.value):
            self.hazards.append((
                "host-sync", node,
                f".{node.func.attr}() on a tensor forces a "
                "device->host sync"))
            return node.func.attr == "cpu"  # a host tensor; the others are host values
        # a method call on a tensor receiver returns a tensor value
        # (x.sum(), state._replace(...)); a bare Name callee does not —
        # calling `f` doesn't make the result tensor unless its args are
        recv = (not isinstance(node.func, ast.Name)
                and self.is_tensor(node.func))
        return any_tensor | recv

    # -- statements ---------------------------------------------------------

    def visit_block(self, stmts: Iterable[ast.stmt]) -> None:
        for stmt in stmts:
            self.visit_stmt(stmt)

    def _assign_target(self, target: ast.AST, tensor: bool) -> None:
        if isinstance(target, ast.Name):
            if tensor:
                self.tensor.add(target.id)
            else:
                self.tensor.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                inner = elt.value if isinstance(elt, ast.Starred) else elt
                self._assign_target(inner, tensor)
        # attribute/subscript stores don't (re)bind local names

    def _isinstance_narrowed(self, test: ast.AST) -> Set[str]:
        """Names proven non-tensor inside an `if isinstance(x, ...)` body
        (conjunctions included)."""
        names: Set[str] = set()
        tests = test.values if isinstance(test, ast.BoolOp) \
            and isinstance(test.op, ast.And) else [test]
        for t in tests:
            if isinstance(t, ast.Call):
                d = dotted(t.func)
                if d == ("isinstance",) and t.args \
                        and isinstance(t.args[0], ast.Name):
                    names.add(t.args[0].id)
        return names

    def visit_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            t = self.is_tensor(stmt.value)
            for target in stmt.targets:
                self._assign_target(target, t)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign_target(stmt.target, self.is_tensor(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            t = self.is_tensor(stmt.value)
            if isinstance(stmt.target, ast.Name):
                if t:
                    self.tensor.add(stmt.target.id)
        elif isinstance(stmt, ast.If):
            if self.is_tensor(stmt.test):
                self.hazards.append((
                    "branch", stmt.test,
                    "Python `if` on a tensor reads it on the host (a device "
                    "sync; use torch.where)"))
            narrowed = self._isinstance_narrowed(stmt.test)
            saved = set(self.tensor)
            self.tensor -= narrowed
            self.visit_block(stmt.body)
            after_body = set(self.tensor)
            self.tensor = set(saved)
            self.visit_block(stmt.orelse)
            self.tensor |= after_body
        elif isinstance(stmt, ast.While):
            if self.is_tensor(stmt.test):
                self.hazards.append((
                    "branch", stmt.test,
                    "Python `while` on a tensor reads it on the host each "
                    "iteration (a device sync)"))
            self.visit_block(stmt.body)  # twice: loop-carried tensorness
            self.visit_block(stmt.body)
            self.visit_block(stmt.orelse)
        elif isinstance(stmt, ast.For):
            t = self.is_tensor(stmt.iter)
            self._assign_target(stmt.target, t)
            self.visit_block(stmt.body)
            self.visit_block(stmt.body)  # twice: loop-carried tensorness
            self.visit_block(stmt.orelse)
        elif isinstance(stmt, ast.Assert):
            if self.is_tensor(stmt.test):
                self.hazards.append((
                    "branch", stmt.test,
                    "`assert` on a tensor reads it on the host (a device "
                    "sync; check it off the hot path)"))
            if stmt.msg is not None:
                self.is_tensor(stmt.msg)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self.is_tensor(stmt.value)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self.is_tensor(item.context_expr)
            self.visit_block(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.visit_block(stmt.body)
            for h in stmt.handlers:
                self.visit_block(h.body)
            self.visit_block(stmt.orelse)
            self.visit_block(stmt.finalbody)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def closes over its tensors: walk it with the
            # enclosing tensor set plus its own (non-static) params
            inner = TensorWalker(stmt, set(_param_names(stmt)))
            inner.tensor |= self.tensor
            inner.run()
            self.hazards.extend(inner.hazards)
            self.calls.extend(inner.calls)
            self.tensor.discard(stmt.name)
        elif isinstance(stmt, (ast.Raise, ast.Delete, ast.Global,
                               ast.Nonlocal, ast.Pass, ast.Break,
                               ast.Continue, ast.Import, ast.ImportFrom)):
            return
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    self.visit_stmt(child)
                elif isinstance(child, ast.expr):
                    self.is_tensor(child)


def analyze_function(func: ast.FunctionDef, tensor_params: Set[str]
                     ) -> TensorWalker:
    return TensorWalker(func, tensor_params).run()


def tensor_names_at_calls(func: ast.FunctionDef, tensor_params: Set[str]):
    """(call, {id(arg) -> tensor}) pairs for in-module propagation."""
    return analyze_function(func, tensor_params).calls

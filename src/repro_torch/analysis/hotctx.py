"""Hot-context inference: which functions of the port run on a hot path
(the loops that `chip_smoke.py` runs under its host-sync detector, and
that a CUDA graph would capture), and which of their names hold tensors.

The torch counterpart of `repro.analysis.jaxctx`. JAX finds its traced
contexts from `jax.jit`, `lax.scan` and friends; eager torch has no such
marker, so the hot contexts are seeded by name, module by module, in
`HOT_ENTRY_POINTS`, as the reference seeds `TRACED_ENTRY_POINTS`:

- `core/protocol.py::draco_window`, the window of the main path;
- the baselines' round steps (`core/baselines.py`);
- `events/engine.py::event_step`;
- `models/model.py::decode_step`;
- the step closures of `launch/steps.py` (the mesh train, unify,
  prefill and serve steps and the mesh mixes);
- `launch/train.py::train_step`.

**In-module call propagation** spreads them: a function called from a
hot context in the same module is hot, and a param is a tensor iff some
call site binds it to an expression that references a tensor name.
Iterated to a fixpoint.

Staticness heuristics (the reference's, with the port's names):

- params named in ``STATIC_PARAM_NAMES`` (configs, tasks, specs,
  callables, generators, devices, meshes, host knobs) are host values;
- params with literal int/float/bool/str defaults or annotations are
  host values;
- attribute chains are cut at ``STATIC_ATTRS`` (`.shape`, `.dtype`,
  `.device`, `.dim()`, `.numel()`, ... are host metadata, no device
  read; an event state's ``event_idx`` and ``tx_count`` are host ints and
  its context's ``tape`` holds host arrays);
- ``int()``, ``float()``, ``bool()``, ``.item()``, ``.tolist()`` and
  ``.numpy()`` return host values (the read itself is the finding);
- ``x is None`` tests and ``isinstance`` / ``len`` / ``hasattr`` calls
  are structural;
- inside an ``if isinstance(x, ...)`` body, `x` is narrowed to a host
  value.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

# module (path under repro_torch/) -> hot entry points and their host params
HOT_ENTRY_POINTS: Dict[str, Dict[str, Set[str]]] = {
    "core/protocol.py": {"draco_window": set()},
    "core/baselines.py": {"sync_symm_round": set(), "sync_push_round": set(),
                          "async_symm_round": set(), "async_push_round": set()},
    "events/engine.py": {"event_step": set()},
    "models/model.py": {"decode_step": set()},
    "launch/steps.py": {"train_step": set(), "unify_step": set(), "prefill_step": set(),
                        "serve_step": set(), "dense": set(), "ring": set(), "none": set()},
    "launch/train.py": {"train_step": set()},
}

STATIC_PARAM_NAMES = {
    "self", "cls", "cfg", "config", "task", "spec", "loss_fn", "eval_fn",
    "final_fn", "metric_name", "algo", "method", "mesh", "client_axes",
    "axis_name", "num_steps", "num_windows", "num_rounds", "eval_every",
    "generator", "gen", "device", "dtype", "lr", "mix", "chunk_fn",
    "blocked_attn_threshold", "vocab_chunk", "seeds", "widx",
    "window_idx", "slots", "psi", "n", "draws_fn", "overrides", "trigger",
    "damping", "drain",
}

# Attribute names that cut a tensor chain to host metadata.
STATIC_ATTRS = {"cfg", "task", "flat_spec", "shape", "ndim", "dtype", "size",
                "device", "dim", "numel", "element_size", "is_cuda", "layout",
                "requires_grad", "stride", "is_contiguous", "data_ptr", "names",
                "_fields", "offsets", "sizes", "num_clients", "tape", "overrides",
                "event_idx", "tx_count", "schedule"}

# Structural predicates: reading them never reads a tensor's value.
STRUCTURAL_CALLS = {"isinstance", "hasattr", "callable", "len", "type",
                    "issubclass", "getattr", "id", "repr", "range", "enumerate",
                    "zip"}


def dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """`a.b.c` -> ("a", "b", "c"); None for non-name-rooted expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _literal_static_default(default: Optional[ast.AST]) -> bool:
    return isinstance(default, ast.Constant) and isinstance(
        default.value, (int, float, bool, str))


def _static_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    d = dotted(ann)
    return d is not None and d[-1] in {"int", "float", "bool", "str"}


@dataclasses.dataclass
class HotContext:
    func: ast.FunctionDef
    origin: str  # "hot entry point", "called from <name>"
    tensor_params: Set[str]


def _param_names(func) -> List[str]:
    a = func.args
    return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
            + [p.arg for p in a.kwonlyargs])


def _default_static_params(func) -> Set[str]:
    """Params that hold host values by naming convention, literal
    default or annotation."""
    a = func.args
    static: Set[str] = set()
    pos = list(a.posonlyargs) + list(a.args)
    pos_defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for p, d in zip(pos, pos_defaults):
        if (p.arg in STATIC_PARAM_NAMES or _literal_static_default(d)
                or _static_annotation(p.annotation)):
            static.add(p.arg)
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if (p.arg in STATIC_PARAM_NAMES or _literal_static_default(d)
                or _static_annotation(p.annotation)):
            static.add(p.arg)
    return static


def entry_points_for(path: str) -> Dict[str, Set[str]]:
    """The hot entry points of the port's module at `path`."""
    p = path.replace("\\", "/")
    if "repro_torch/" not in p:
        return {}
    rel = p.split("repro_torch/", 1)[1]
    return HOT_ENTRY_POINTS.get(rel, {})


class FunctionIndex:
    """Per-module index of functions and their hot contexts."""

    def __init__(self, tree: ast.Module, path: str):
        self.by_name: Dict[str, List[ast.FunctionDef]] = {}
        self._collect(tree)
        self.contexts: Dict[ast.FunctionDef, HotContext] = {}
        for name, static in entry_points_for(path).items():
            for func in self.by_name.get(name, ()):
                self._mark(func, "hot entry point", set(static))
        self._propagate_calls()

    def _collect(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.by_name.setdefault(child.name, []).append(child)
            self._collect(child)

    def _mark(self, func, origin: str, static: Set[str]) -> None:
        tensors = (set(_param_names(func)) - static - _default_static_params(func))
        ctx = self.contexts.get(func)
        if ctx is None:
            self.contexts[func] = HotContext(func, origin, tensors)
        else:
            ctx.tensor_params |= tensors

    def _propagate_calls(self) -> None:
        from repro_torch.analysis.tensorness import tensor_names_at_calls

        for _ in range(8):  # fixpoint (module call graphs are shallow)
            changed = False
            for func, ctx in list(self.contexts.items()):
                for call, tensor_args in tensor_names_at_calls(func, ctx.tensor_params):
                    d = dotted(call.func)
                    if d is None or len(d) != 1:
                        continue
                    for callee in self.by_name.get(d[0], ()):
                        if callee is func:
                            continue
                        bound = self._bind(callee, call, tensor_args)
                        prev = self.contexts.get(callee)
                        before = set(prev.tensor_params) if prev else None
                        self._mark(callee, f"called from {func.name}",
                                   set(_param_names(callee)) - bound)
                        if before != self.contexts[callee].tensor_params:
                            changed = True
            if not changed:
                return

    @staticmethod
    def _bind(callee, call: ast.Call, tensor_args) -> Set[str]:
        """Param names of `callee` receiving tensor arguments at `call`."""
        names = _param_names(callee)
        a = callee.args
        pos_names = [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
        bound: Set[str] = set()
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(pos_names) and tensor_args.get(id(arg), False):
                bound.add(pos_names[i])
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in names \
                    and tensor_args.get(id(kw.value), False):
                bound.add(kw.arg)
        return bound

    def hot_contexts(self) -> Iterator[HotContext]:
        return iter(self.contexts.values())

"""`repro_torch.analysis`: the port's torch-aware static analyzer (port
of `repro.analysis`).

The port's speed and correctness rest on invariants the type system
never sees: no host read and no Python branch on a tensor inside the
hot loops (a window, a round, an event, a decode or train step), which
`chip_smoke.py` checks at run time on the card and a CUDA graph of the
loop would need (ROADMAP item 15); an explicit generator for every draw;
no host constant copied per call and no kernel built in a loop; TF32
left off; and the documented ``(N, Dflat)`` / ``(D, N, Dflat)`` /
``(D, N, N)`` plane contracts. This package encodes them as lint rules
over the Python AST — pure stdlib, no torch import, so the lint gate
runs anywhere. Its rule ids differ from the reference's wherever the
meaning differs, so one suppression comment means one thing to both
analyzers (see `rules`).

Usage:

    python -m repro_torch.analysis src/repro_torch tests chip_smoke.py
    python -m repro_torch.analysis src/repro_torch tests chip_smoke.py --strict
    python -m repro_torch.analysis src/repro_torch --json report.json

Suppressions are per-rule and *must* carry a reason::

    flag = bool(fired)  # repro-lint: disable=TENSOR-PY-BRANCH(one read per
                        # TX row is the mode's design)

A suppression without a reason does not suppress — it raises
SUPPRESS-NO-REASON instead.
"""
from repro_torch.analysis.core import (
    Finding,
    Rule,
    RULES,
    SourceFile,
    analyze_paths,
    iter_python_files,
    register_rule,
    report_json,
)

# Importing the rules package registers every built-in rule.
from repro_torch.analysis import rules as _rules  # noqa: F401

__all__ = [
    "Finding",
    "Rule",
    "RULES",
    "SourceFile",
    "analyze_paths",
    "iter_python_files",
    "register_rule",
    "report_json",
]

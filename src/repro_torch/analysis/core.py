"""Rule engine: findings, reasoned suppressions, file walking, registry.

Everything here is plain stdlib — the analyzer must run in environments
without torch (the CI lint job, pre-commit hooks, editors). A copy of
`repro.analysis.core`, so that one suppression comment reads the same
to both analyzers.

Suppression grammar (one comment, one or more entries)::

    # repro-lint: disable=RULE-ID(reason text)
    # repro-lint: disable=RULE-A(why a), RULE-B(why b)
    # repro-lint: disable-next-line=RULE-ID(reason)
    # repro-lint: disable-file=RULE-ID(reason)

A trailing comment suppresses its own line; a comment-only line
suppresses the line below it (so long suppressions don't force long
code lines); ``disable-file`` suppresses the whole file. The reason is
mandatory: a bare ``disable=RULE-ID`` suppresses nothing and raises
SUPPRESS-NO-REASON at that line — the policy is that every silenced
finding documents *why* it is safe.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import tokenize
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str = "error"

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered rule: `check(SourceFile) -> iterable of Finding`."""

    id: str
    description: str
    check: Callable[["SourceFile"], Iterable[Finding]]


RULES: Dict[str, Rule] = {}

# Rule-ID grammar shared by the registry and the suppression parser.
_RULE_ID_RE = re.compile(r"^[A-Z][A-Z0-9]*(-[A-Z0-9]+)*$")
_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*(?P<kind>disable(?:-next-line|-file)?)\s*=\s*"
    r"(?P<entries>.+?)\s*$")
# An entry is RULE-ID(reason). Reasons may contain commas (entries are
# matched by span, not split on separators) but not parentheses.
_ENTRY_RE = re.compile(r"(?P<rule>[A-Z][A-Z0-9-]*)\s*\((?P<reason>[^()]*)\)")
_BARE_ID_RE = re.compile(r"[A-Z][A-Z0-9-]*")

SUPPRESS_NO_REASON = "SUPPRESS-NO-REASON"
PARSE_ERROR = "PARSE-ERROR"


def register_rule(rule_id: str, description: str):
    """Class/function decorator adding a rule to the global registry.

    Accepts either a callable ``check(source_file)`` or a class with a
    ``check(self, source_file)`` method (instantiated once).
    """
    if not _RULE_ID_RE.match(rule_id):
        raise ValueError(f"rule id {rule_id!r} must be UPPER-KEBAB-CASE")

    def deco(obj):
        check = obj().check if isinstance(obj, type) else obj
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, description, check)
        return obj

    return deco


@dataclasses.dataclass
class _Suppression:
    rule: str
    line: int  # line the suppression applies to (0 = whole file)
    reason: str
    used: bool = False


class SourceFile:
    """One parsed module: source text, AST, and its suppression table."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_failure: Optional[Finding] = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.parse_failure = Finding(
                PARSE_ERROR, path, e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}")
        self.suppressions: List[_Suppression] = []
        self.malformed: List[Finding] = []
        self._scan_suppressions()

    # -- suppression handling ------------------------------------------------

    def _scan_suppressions(self) -> None:
        for comment, lineno, comment_only in _iter_comments(self.text):
            m = _SUPPRESS_RE.search(comment)
            if not m:
                continue
            kind = m.group("kind")
            if kind == "disable-file":
                target = 0
            elif kind == "disable-next-line" or comment_only:
                target = lineno + 1
            else:
                target = lineno
            entries = m.group("entries")
            for em in _ENTRY_RE.finditer(entries):
                reason = em.group("reason").strip()
                if not reason:
                    self.malformed.append(Finding(
                        SUPPRESS_NO_REASON, self.path, lineno, 0,
                        f"suppression {em.group('rule')!r} carries no "
                        "reason; write disable=RULE-ID(why this is safe)"))
                    continue
                self.suppressions.append(
                    _Suppression(em.group("rule"), target, reason))
            # rule ids left over once reasoned entries are cut out are
            # bare `disable=RULE-ID` suppressions: rejected, not honored
            for bare in _BARE_ID_RE.finditer(_ENTRY_RE.sub("", entries)):
                self.malformed.append(Finding(
                    SUPPRESS_NO_REASON, self.path, lineno, 0,
                    f"suppression {bare.group(0)!r} carries no reason; "
                    "write disable=RULE-ID(why this is safe)"))

    def is_suppressed(self, finding: Finding) -> bool:
        for s in self.suppressions:
            if s.rule != finding.rule:
                continue
            if s.line == 0 or s.line == finding.line:
                s.used = True
                return True
        return False

    # -- convenience accessors for rules ------------------------------------

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule: str, node, message: str,
                severity: str = "error") -> Finding:
        return Finding(rule, self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message, severity)


def _iter_comments(text: str) -> Iterator[Tuple[str, int, bool]]:
    """Yield ``(comment, lineno, is_comment_only_line)`` via tokenize
    (robust against '#' inside string literals)."""
    import io

    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                line = tok.line.strip()
                yield tok.string, tok.start[0], line.startswith("#")
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # the PARSE-ERROR finding covers unparseable files
        return


# -- file walking and the analysis driver -----------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache",
              ".hypothesis", "node_modules", ".venv", "venv"}


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def analyze_file(path: str, rules: Optional[Iterable[Rule]] = None,
                 text: Optional[str] = None) -> List[Finding]:
    if text is None:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    src = SourceFile(path, text)
    findings: List[Finding] = list(src.malformed)
    if src.parse_failure is not None:
        return findings + [src.parse_failure]
    for rule in (RULES.values() if rules is None else rules):
        for f in rule.check(src):
            if not src.is_suppressed(f):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Iterable[Rule]] = None
                  ) -> Tuple[List[Finding], int]:
    """Run `rules` (default: all registered) over every .py file under
    `paths`. Returns ``(findings, files_scanned)``."""
    findings: List[Finding] = []
    n = 0
    for path in iter_python_files(paths):
        n += 1
        findings.extend(analyze_file(path, rules))
    return findings, n


def report_json(findings: List[Finding], files_scanned: int) -> str:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return json.dumps({
        "version": 1,
        "files_scanned": files_scanned,
        "rules": sorted(RULES),
        "counts": dict(sorted(counts.items())),
        "findings": [f.to_json() for f in findings],
    }, indent=2)

"""CLI: ``python -m repro_torch.analysis [paths...] [--strict] [--json FILE]``,
e.g. ``python -m repro_torch.analysis src/repro_torch tests chip_smoke.py --strict``.

Exit codes: 0 clean (warnings allowed unless --strict), 1 findings,
2 usage error.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis.core import RULES, analyze_paths, report_json


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch-aware static analyzer for the port: host syncs "
        "and tensor branches on the hot paths, generator discipline, host "
        "constants, kernel builds in loops, TF32, plane contracts.")
    parser.add_argument("paths", nargs="*",
                        default=["src/repro_torch", "tests", "chip_smoke.py"],
                        help="files or directories (default: src/repro_torch tests "
                        "chip_smoke.py)")
    parser.add_argument("--strict", action="store_true",
                        help="warnings fail too (the CI gate)")
    parser.add_argument("--json", metavar="FILE", default=None,
                        help="write the machine-readable report here "
                        "('-' for stdout)")
    parser.add_argument("--select", metavar="RULES", default=None,
                        help="comma-separated rule ids to run")
    parser.add_argument("--ignore", metavar="RULES", default=None,
                        help="comma-separated rule ids to skip")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        width = max(len(r) for r in RULES)
        for rid in sorted(RULES):
            print(f"{rid:<{width}}  {RULES[rid].description}")
        return 0

    rules = dict(RULES)
    if args.select:
        wanted = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = wanted - set(rules)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = {k: v for k, v in rules.items() if k in wanted}
    if args.ignore:
        dropped = {r.strip() for r in args.ignore.split(",") if r.strip()}
        rules = {k: v for k, v in rules.items() if k not in dropped}

    findings, files_scanned = analyze_paths(args.paths,
                                            rules=list(rules.values()))

    # with --json -, stdout must stay a single JSON document for the
    # consumer; the human-readable report moves to stderr
    human = sys.stderr if args.json == "-" else sys.stdout
    if args.json:
        payload = report_json(findings, files_scanned)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(payload + "\n")

    errors = [f for f in findings if f.severity == "error"]
    warnings = [f for f in findings if f.severity != "error"]
    for f in findings:
        print(f.format(), file=human)
    tail = (f"{files_scanned} files scanned; "
            f"{len(errors)} error(s), {len(warnings)} warning(s)")
    failed = bool(errors) or (args.strict and bool(warnings))
    print(("FAIL: " if failed else "OK: ") + tail, file=human)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

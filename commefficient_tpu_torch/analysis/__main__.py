"""CLI for the port's invariant linter (``python -m
commefficient_tpu_torch.analysis``).

Exit codes: 0 clean, 1 findings, 2 usage error. The last stdout line is
ALWAYS the machine-readable JSON summary

    {"kind": "invariant_lint", "rules": [...], "files": N,
     "findings": [{"rule", "path", "line", "message"}, ...],
     "counts": {rule: n}, "clean": bool}

on every exit path, including usage errors (``error`` key set), so a
caller parses one line instead of scraping prose (``chip_smoke.py``'s
``lint`` phase reads it).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from commefficient_tpu_torch.analysis.core import (
    PACKAGE_ROOT,
    analyzer_registry,
    run_analyzers,
)


def _summary_line(**kw) -> None:
    print(json.dumps({"kind": "invariant_lint", **kw}))


def _empty(**kw) -> dict:
    return {"rules": [], "files": 0, "findings": [], "counts": {},
            "clean": False, **kw}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m commefficient_tpu_torch.analysis",
        description="run the invariant linter over the port's package",
    )
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all; "
                    "see --list-rules)")
    ap.add_argument("--json", action="store_true",
                    help="emit only the JSON summary line")
    ap.add_argument("--list-rules", action="store_true",
                    help="list rule names + descriptions and exit 0")
    ap.add_argument("--root", default=None,
                    help="directory to lint (default: the installed "
                    "commefficient_tpu_torch package)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        # --help exits 0 and keeps argparse's behavior; a bad flag must
        # still honor the summary-line contract on stdout
        if e.code in (0, None):
            raise
        _summary_line(**_empty(
            error="argument parsing failed (see usage on stderr)"))
        return 2

    registry = analyzer_registry()
    if args.list_rules:
        for rule in sorted(registry):
            print(f"{rule:18s} {registry[rule].DESCRIPTION}")
        print("pragma grammar: '# lint: allow[rule-name] <reason>' on the "
              "violating line or the line above; the reason is required")
        _summary_line(**_empty(rules=sorted(registry), clean=True,
                               listed=True))
        return 0

    rules = None
    if args.rules is not None:
        # order-preserving dedupe: a repeated rule must not double-run
        rules = list(dict.fromkeys(
            r.strip() for r in args.rules.split(",") if r.strip()
        ))
        unknown = [r for r in rules if r not in registry]
        if not rules or unknown:
            # an EMPTY selection (e.g. --rules "$UNSET_VAR") would run
            # zero analyzers and "pass" vacuously — usage error instead
            msg = ("--rules selected no rules" if not rules else
                   f"unknown rule(s): {', '.join(unknown)}") + \
                  f" (known: {', '.join(sorted(registry))})"
            if not args.json:
                print(msg)
            _summary_line(**_empty(error=msg))
            return 2

    # resolve so `--root .` keeps a real directory name in the path
    # prefix instead of an empty one (Path('.').name == "")
    root = (Path(args.root).resolve() if args.root is not None
            else PACKAGE_ROOT)
    if not root.is_dir():
        msg = f"not a directory: {root}"
        if not args.json:
            print(msg)
        _summary_line(**_empty(error=msg))
        return 2

    findings, index = run_analyzers(root=root, rules=rules)
    ran = sorted(registry) if rules is None else rules
    prefix = f"{root.name}/"
    if not args.json:
        for f in findings:
            print(f.format(prefix=prefix))
        if findings:
            print(f"\n{len(findings)} finding(s). Fix the violation, or — "
                  "when the host-side behavior is intentional — annotate "
                  "the line with '# lint: allow[rule] <reason>'.")
        else:
            print(f"OK — {len(index.files)} file(s) clean under "
                  f"{len(ran)} rule(s)")
    counts: dict = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    _summary_line(
        rules=ran,
        files=len(index.files),
        findings=[{**f.to_dict(), "path": prefix + f.path}
                  for f in findings],
        counts=counts,
        clean=not findings,
    )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

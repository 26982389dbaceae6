"""registry-dispatch: registry-keyed dispatch must not leak out of its
home package (the same rule under torch as in the reference's
``analysis/dispatch.py``).

The port's compress/ registry puts every mode's algebra behind
``compress.get_compressor``; control/ does the same for rung-selection
policies, resilience/ for recovery policies. The invariant that keeps a
new compressor (or policy) a one-file change is that NOBODY else
branches on the registry's key strings. This analyzer walks the
package ASTs and fails on any

  * comparison involving a dispatch name/attribute
    (``cfg.mode == "sketch"``, ``mode != 'fedavg'``,
    ``cfg.control_policy in (...)``),
  * dict/registry subscript keyed by a dispatch expression
    (``{...}[cfg.mode]``, ``POLICIES[cfg.control_policy]``),
  * ``match cfg.mode:`` / ``match cfg.control_policy:`` statement,

outside that family's allowlist (``FAMILIES`` below). AST-based, so
docstrings/comments that merely MENTION modes or policies never
false-positive. A local that merely shares a family's name (a bitmask
called ``mode``) is a finding too: rename it, so that a grep for the
family finds dispatch and nothing else.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List

from commefficient_tpu_torch.analysis.core import (
    Finding,
    PACKAGE_ROOT,
    PackageIndex,
)

RULE = "registry-dispatch"
DESCRIPTION = (
    "no mode/control_policy/recover_policy key-string dispatch outside "
    "compress/, control/, resilience/ (+ utils/config.py validation)"
)

PACKAGE = PACKAGE_ROOT

# dispatch family -> (paths, relative to the package root, where that
# family's dispatch is LEGAL)
FAMILIES = {
    "mode": ("compress/", "utils/config.py"),
    "control_policy": ("control/", "utils/config.py"),
    "recover_policy": ("resilience/", "utils/config.py"),
}


def _dispatch_name(node: ast.AST):
    """The family name for expressions naming a dispatch key (``mode``,
    ``*.mode``, ``control_policy``, ``*.control_policy``), else None."""
    if isinstance(node, ast.Name) and node.id in FAMILIES:
        return node.id
    if isinstance(node, ast.Attribute) and node.attr in FAMILIES:
        return node.attr
    return None


def scan_file(path: Path, families=None) -> list:
    """[(lineno, family, snippet)] of dispatch violations in one file.
    ``families``: restrict to these family names (default: all).
    (The reference's ``scan_file`` shape.)"""
    src = Path(path).read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:  # a broken file is its own CI problem
        return [(e.lineno or 0, "?", f"unparseable: {e.msg}")]
    return scan_tree(tree, src.splitlines(), families)


def scan_tree(tree: ast.AST, lines: list, families=None) -> list:
    """``scan_file`` over an already-parsed tree — what ``analyze`` uses
    so the shared ``PackageIndex`` parse is not repeated per analyzer."""
    out = []

    def hit(node, family):
        if families is not None and family not in families:
            return
        ln = getattr(node, "lineno", 0)
        snippet = lines[ln - 1].strip() if 0 < ln <= len(lines) else ""
        out.append((ln, family, snippet))

    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            for expr in [node.left, *node.comparators]:
                fam = _dispatch_name(expr)
                if fam is not None:
                    hit(node, fam)
                    break
        elif isinstance(node, ast.Subscript):
            fam = _dispatch_name(node.slice)
            if fam is not None:
                hit(node, fam)
        elif isinstance(node, ast.Match):
            fam = _dispatch_name(node.subject)
            if fam is not None:
                hit(node, fam)
    return sorted(out)  # ast.walk is BFS; report in source order


def _banned_families(rel: str) -> tuple:
    """The families this file may NOT dispatch on — a file may be home
    to one family and off-limits to another (utils/config.py is
    allowlisted for all three; control/ may validate policies but not
    branch on cfg.mode)."""
    return tuple(
        fam for fam, allowed in FAMILIES.items()
        if not any(rel == a or rel.startswith(a) for a in allowed)
    )


def scan_package(package_root: Path = PACKAGE) -> dict:
    """{relative_path: [(lineno, family, snippet)]} over the package,
    per-family allowlists applied."""
    violations = {}
    for path in sorted(Path(package_root).rglob("*.py")):
        rel = path.relative_to(package_root).as_posix()
        banned = _banned_families(rel)
        if not banned:
            continue
        hits = scan_file(path, families=banned)
        if hits:
            violations[rel] = hits
    return violations


def analyze(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    for sf in index.trees():
        banned = _banned_families(sf.rel)
        if not banned:
            continue
        for ln, fam, _snippet in scan_tree(sf.tree, sf.lines,
                                           families=banned):
            home = FAMILIES.get(fam, ("?",))[0]
            findings.append(sf.finding(
                RULE, ln,
                f"{fam}-string dispatch outside {home} — route through "
                "the registry (compress.get_compressor / "
                "control.build_controller / resilience.build_resilience) "
                "or Config properties",
            ))
    return findings

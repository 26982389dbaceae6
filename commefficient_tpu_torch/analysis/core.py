"""Shared core of the port's invariant linter: finding model, pragma
grammar, package index, and the analyzer runner (the port's own copy of
``commefficient_tpu/analysis/core.py``).

The port's hardest-won guarantees — every scan block bit-equal to its
per-round twin, bit-exact resume and rollback, disjoint seeded streams,
a CUDA graph that holds no host read — are *discipline* invariants:
nothing crashes when they erode, results just silently stop being
reproducible (or a capture fails on the card only, on the branch a CPU
run never took). An AST lint defends them mechanically; each rule is
one small analyzer module over this shared framework.

Pieces every analyzer shares:

  * ``Finding`` — one violation: (rule, path, lineno, message, snippet).
  * Pragma suppressions — ``# lint: allow[rule-name] <reason>`` on the
    violating line, the line directly above it, or atop the multi-line
    statement containing the violation. The reason is REQUIRED: a
    pragma without one (or naming an unknown rule) is itself a
    violation (rule ``pragma``), so exemptions stay auditable.
  * ``PackageIndex`` — every ``*.py`` under the scanned root parsed
    once (source, AST, pragmas); analyzers walk these shared trees.
    An unparseable file is a finding (rule ``parse``), not a crash.
  * ``run_analyzers`` — applies per-analyzer allowlists and pragma
    suppression, returns findings in (path, line, rule) order. The CLI
    (``__main__``) turns a non-empty list into exit 1 and always ends
    stdout with one machine-readable JSON summary line.

Analyzer protocol (see the five sibling modules): a module exposing
``RULE`` (kebab-case name), ``DESCRIPTION`` (one line), and
``analyze(index) -> list[Finding]`` over raw, unsuppressed violations —
suppression and ordering are the runner's job, so no analyzer can forget
them. The framework is pure stdlib ``ast`` — importing it never imports
torch, so the lint runs in about a second on any host.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

# the package this framework ships in (and lints by default): analysis/
# lives one level below the port's package root
PACKAGE_ROOT = Path(__file__).resolve().parent.parent

# rules that are not analyzers but can still appear on findings: ``parse``
# (file did not parse) and ``pragma`` (malformed suppression). Neither is
# suppressible — a pragma that silences pragma hygiene would be a hole.
META_RULES = ("parse", "pragma")

_PRAGMA_RE = re.compile(
    r"#\s*lint:\s*allow\[(?P<rule>[A-Za-z0-9_-]+)\]\s*(?P<reason>.*?)\s*$"
)


@dataclass(frozen=True, order=True)
class Finding:
    """One invariant violation, stably ordered for deterministic output."""

    path: str  # scanned-root-relative posix path
    lineno: int
    rule: str
    message: str
    snippet: str = ""

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.lineno,
            "message": self.message,
        }

    def format(self, prefix: str = "") -> str:
        loc = f"{prefix}{self.path}:{self.lineno}"
        tail = f": {self.snippet}" if self.snippet else ""
        return f"{loc}: [{self.rule}] {self.message}{tail}"


@dataclass(frozen=True)
class Pragma:
    """One ``# lint: allow[rule] reason`` comment. ``standalone`` means
    the pragma is a comment-only line: only those also cover the line /
    statement BELOW them — a trailing pragma covers its own line alone,
    so a violation later inserted under it never inherits the exemption."""

    lineno: int
    rule: str
    reason: str
    standalone: bool = True


@dataclass
class SourceFile:
    """One parsed module: the unit every analyzer operates on."""

    rel: str  # posix path relative to the scanned root
    path: Path
    source: str
    lines: List[str]
    tree: Optional[ast.AST]  # None when the file does not parse
    parse_error: Optional[str] = None
    pragmas: List[Pragma] = field(default_factory=list)
    _stmt_spans: Optional[List[Tuple[int, int]]] = None

    def snippet(self, lineno: int) -> str:
        if 0 < lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def stmt_span(self, lineno: int) -> Tuple[int, int]:
        """(first, last) line of the smallest statement (or except
        handler) containing ``lineno`` — so one pragma above a
        multi-line call covers every line the call spans."""
        if self._stmt_spans is None:
            spans = []
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    if isinstance(node, (ast.stmt, ast.excepthandler)) \
                            and getattr(node, "end_lineno", None):
                        spans.append((node.lineno, node.end_lineno))
            self._stmt_spans = spans
        best = (lineno, lineno)
        best_size = None
        for start, end in self._stmt_spans:
            if start <= lineno <= end:
                size = end - start
                if best_size is None or size < best_size:
                    best, best_size = (start, end), size
        return best

    def finding(self, rule: str, lineno: int, message: str) -> Finding:
        return Finding(rule=rule, lineno=lineno, path=self.rel,
                       message=message, snippet=self.snippet(lineno))


def _scan_pragmas(source: str) -> List[Pragma]:
    """Pragmas from REAL comment tokens only (``tokenize``), so a
    docstring or string literal that merely quotes the grammar — this
    framework's own documentation, for a start — never registers as a
    suppression."""
    out = []
    lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if m:
                ln = tok.start[0]
                before = lines[ln - 1][: tok.start[1]] if ln <= len(lines) \
                    else ""
                out.append(Pragma(lineno=ln, rule=m.group("rule"),
                                  reason=m.group("reason"),
                                  standalone=not before.strip()))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # the file-level parse finding already covers a broken file
    return out


class PackageIndex:
    """Every ``*.py`` under ``root``, parsed once and shared by all
    analyzers (the call-graph analyzer alone walks every tree; parsing
    per-analyzer would quintuple the work)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.files: Dict[str, SourceFile] = {}
        for path in sorted(self.root.rglob("*.py")):
            rel = path.relative_to(self.root).as_posix()
            try:
                source = path.read_text()
            # unreadable file is a finding, not a crash — including a
            # non-UTF-8 encoding, which must not cost the gate scripts
            # their summary-line-on-every-exit-path contract
            except (OSError, UnicodeDecodeError) as e:
                self.files[rel] = SourceFile(
                    rel=rel, path=path, source="", lines=[], tree=None,
                    parse_error=f"unreadable: {e}",
                )
                continue
            lines = source.splitlines()
            tree, err = None, None
            try:
                tree = ast.parse(source, filename=str(path))
            except SyntaxError as e:
                err = f"syntax error: {e.msg}"
            self.files[rel] = SourceFile(
                rel=rel, path=path, source=source, lines=lines, tree=tree,
                parse_error=err, pragmas=_scan_pragmas(source),
            )

    def trees(self) -> Iterable[SourceFile]:
        """The parseable files, in path order."""
        for rel in sorted(self.files):
            f = self.files[rel]
            if f.tree is not None:
                yield f

    # ---- framework-level findings ------------------------------------

    def parse_findings(self) -> List[Finding]:
        return [
            Finding(rule="parse", path=f.rel, lineno=0,
                    message=f.parse_error or "unparseable")
            for f in self.files.values()
            if f.tree is None
        ]

    def pragma_findings(self, known_rules: Iterable[str]) -> List[Finding]:
        """Malformed pragmas are violations: a reason-less exemption is
        unauditable, and a typo'd rule name would otherwise silently
        suppress nothing forever."""
        known = set(known_rules)
        out = []
        for f in self.files.values():
            for p in f.pragmas:
                if p.rule not in known:
                    out.append(f.finding(
                        "pragma", p.lineno,
                        f"pragma names unknown rule {p.rule!r} "
                        f"(known: {', '.join(sorted(known))})",
                    ))
                elif not p.reason:
                    out.append(f.finding(
                        "pragma", p.lineno,
                        f"pragma allow[{p.rule}] carries no reason — "
                        "every exemption must say why",
                    ))
        return out

    # ---- suppression --------------------------------------------------

    def suppressed(self, finding: Finding) -> bool:
        """A well-formed pragma for ``finding.rule`` suppresses the
        finding when it sits on the finding's line or the first line of
        the multi-line statement containing it (trailing-comment form),
        or — as a standalone comment-only line — directly above either
        (one pragma atop a multi-line call covers the whole call). A
        TRAILING pragma never covers the line below it: a violation
        later inserted under a pragma'd line must not silently inherit
        the exemption. Meta-rule findings (``parse``/``pragma``) are
        never suppressible."""
        if finding.rule in META_RULES:
            return False
        f = self.files.get(finding.path)
        if f is None:
            return False
        stmt_start, _ = f.stmt_span(finding.lineno)
        same_line = {finding.lineno, stmt_start}
        line_above = {finding.lineno - 1, stmt_start - 1}
        for p in f.pragmas:
            if p.rule != finding.rule or not p.reason:
                continue
            if p.lineno in same_line or (p.standalone
                                         and p.lineno in line_above):
                return True
        return False


# ---- shared AST resolution helpers (one semantics for all analyzers) ----


def final_name(expr: ast.AST) -> Optional[str]:
    """The last segment of a Name/Attribute expression (``torch.distributed.all_reduce``
    -> ``all_reduce``), None for anything else."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def module_imports(tree: ast.AST) -> Dict[str, str]:
    """{bound name: dotted path} over a module's absolute imports.
    Relative imports are omitted — callers that need them resolved
    package-locally (the purity call graph) anchor them against the
    module's own dotted name instead; for the line-level analyzers the
    interesting targets (numpy/torch/stdlib) are never relative."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def dotted_path(expr: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Resolve an attribute chain through an import table:
    ``np.random.default_rng`` -> ``numpy.random.default_rng``. None when
    the chain is not rooted in an imported name."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    base = imports.get(expr.id)
    if base is None:
        return None
    return ".".join([base] + list(reversed(parts)))


def analyzer_registry() -> Dict[str, object]:
    """{rule name: analyzer module}, imported lazily so ``core`` has no
    import cycle with the analyzer modules that import it."""
    from commefficient_tpu_torch.analysis import (
        collectives,
        dispatch,
        exceptions,
        purity,
        rng,
    )

    mods = (purity, rng, collectives, dispatch, exceptions)
    return {m.RULE: m for m in mods}


def run_analyzers(
    root: Optional[Path] = None,
    rules: Optional[Iterable[str]] = None,
    index: Optional[PackageIndex] = None,
) -> Tuple[List[Finding], PackageIndex]:
    """Run the selected analyzers (default: all) over ``root`` (default:
    the installed ``commefficient_tpu_torch`` package) and return the surviving
    findings in deterministic (path, line, rule) order.

    Framework-level findings ride along regardless of selection: parse
    failures (a broken file can hide anything) and malformed pragmas
    (rule ``pragma``). Raises ``KeyError`` naming the unknown rule if
    ``rules`` contains one — the CLI turns that into a usage error.
    """
    registry = analyzer_registry()
    if rules is None:
        selected = list(registry)
    else:
        # dedupe, order-preserving: `--rules x,x` must not double-run an
        # analyzer and double-report every finding
        selected = list(dict.fromkeys(rules))
        unknown = [r for r in selected if r not in registry]
        if unknown:
            raise KeyError(
                f"unknown rule(s) {', '.join(unknown)} "
                f"(known: {', '.join(sorted(registry))})"
            )
    if index is None:
        index = PackageIndex(root if root is not None else PACKAGE_ROOT)
    findings = index.parse_findings()
    findings += index.pragma_findings(registry)
    for rule in selected:
        raw = registry[rule].analyze(index)
        findings += [f for f in raw if not index.suppressed(f)]
    return sorted(findings), index

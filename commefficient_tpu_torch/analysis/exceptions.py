"""exception-hygiene: no bare ``except:`` and no silently swallowed
``except Exception: pass`` in library code (the same rule under torch as
in the reference's ``analysis/exceptions.py``).

resilience/ makes error *provenance* a feature: divergence recovery
re-raises with the original failure chained, checkpoint fallback names
what it walked past, and the preemption path records why it stopped; on
the card a failed CUDA-graph capture raises with its cause chained
rather than falling back to eager rounds. A silently swallowed broad except undoes all of that — the
failure evaporates and the next symptom appears rounds later with no
chain back. The two patterns this analyzer bans:

  * ``except:`` (bare) — also traps ``KeyboardInterrupt`` /
    ``SystemExit``, so a run that should die on Ctrl-C spins on;
  * ``except Exception:`` / ``except BaseException:`` whose entire body
    is ``pass`` / ``...`` / ``continue`` — the swallow. Handling is
    fine; vanishing is not.

A narrow swallow (``except (ImportError, AttributeError): pass`` around
a version probe) stays legal: the author named what can happen. Broad
swallows that are genuinely intentional — best-effort telemetry
metadata, dump paths that must never raise over the original error —
carry ``# lint: allow[exception-hygiene] <reason>`` on the ``except``
line, so every one documents why losing the error is acceptable there.
``ALLOWLIST`` can exempt whole files; it is intentionally empty — the
per-line pragma names a reason, a path allowlist hides one.
"""

from __future__ import annotations

import ast
from typing import List

from commefficient_tpu_torch.analysis.core import Finding, PackageIndex

RULE = "exception-hygiene"
DESCRIPTION = (
    "no bare except: or swallowed 'except Exception: pass' in library "
    "code (chain, log, or pragma with a reason)"
)

# path prefixes (package-root-relative) exempt from this rule; empty on
# purpose — use the per-line pragma, which forces a written reason
ALLOWLIST: tuple = ()

_BROAD = ("Exception", "BaseException")


def _is_broad(type_expr) -> bool:
    if isinstance(type_expr, ast.Name):
        return type_expr.id in _BROAD
    if isinstance(type_expr, ast.Attribute):  # builtins.Exception etc.
        return type_expr.attr in _BROAD
    return False


def _swallows(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / `...`
        return False
    return True


def analyze(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    for sf in index.trees():
        if any(sf.rel == a or sf.rel.startswith(a) for a in ALLOWLIST):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(sf.finding(
                    RULE, node.lineno,
                    "bare 'except:' — traps KeyboardInterrupt/SystemExit "
                    "too; name the exceptions (or 'except Exception' with "
                    "real handling)",
                ))
            elif _is_broad(node.type) and _swallows(node.body):
                findings.append(sf.finding(
                    RULE, node.lineno,
                    "'except Exception' that swallows silently — chain it "
                    "(raise ... from e), log it, or annotate with "
                    "# lint: allow[exception-hygiene] <reason>",
                ))
    return findings

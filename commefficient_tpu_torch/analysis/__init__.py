"""The port's invariant linter: static analysis enforcing the contracts
the test suite can only check after a violation ships (the port's
counterpart of ``commefficient_tpu/analysis/``, with the same five rule
names, pragma grammar and CLI, each rule read for torch).

Five analyzers over a shared AST/call-graph core (``core.py``):

  * ``traced-purity``      — no host read a CUDA graph cannot hold
                             (``.item()``, ``.tolist()``, ``.cpu()``,
                             ``.numpy()``, ``nonzero``, ``masked_select``,
                             ``unique``, ``torch.tensor`` of host data,
                             ``torch.cuda.synchronize``, a coerced
                             parameter) and no wall-clock/host-rng/
                             print/IO in code reachable from what a
                             ``torch.cuda.graph`` block calls or from the
                             declared capture roots; branches taken only
                             when ``graph_capturing`` is false are pruned
                             (``purity.py``);
  * ``rng-stream``         — numpy seeds derive from declared stream
                             constants; a ``torch.Generator`` is seeded by
                             ``manual_seed(<derived expr>)``; no draw from
                             torch's, numpy's or the stdlib's global
                             stream (``rng.py``);
  * ``collective-axis``    — every ``torch.distributed`` collective or
                             point-to-point call sits in a counted group
                             method of ``parallel/mesh.py``, passes
                             ``group=``, and names no peer by a literal
                             int; axis names are the declared constants
                             (``collectives.py``);
  * ``registry-dispatch``  — no mode/policy key-string dispatch outside
                             its home package (``dispatch.py``);
  * ``exception-hygiene``  — no bare ``except:`` / silently swallowed
                             ``except Exception: pass`` in library code
                             (``exceptions.py``).

Suppressions are per line and per rule with a MANDATORY reason —
``# lint: allow[rule-name] <reason>`` on the violating line, the line
above it, or atop the multi-line statement containing it — and a
malformed pragma is itself a violation. Run it:

    python -m commefficient_tpu_torch.analysis              # exit 1 on findings
    python -m commefficient_tpu_torch.analysis --list-rules
    python -m commefficient_tpu_torch.analysis --rules traced-purity,rng-stream
    python -m commefficient_tpu_torch.analysis --json

The last stdout line is always a machine-readable JSON summary
(``{"kind": "invariant_lint", ...}``) on every exit path. Wired into
tier-1 by tests/test_torch_analysis.py (clean-package gate, per-rule
detects-violation self-tests, and the capture rule's reachable set held
against the functions a block program really enters). Pure stdlib
``ast``: no module of this package imports torch or the reference.
"""

from commefficient_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    PackageIndex,
    analyzer_registry,
    run_analyzers,
)

__all__ = ["Finding", "PackageIndex", "analyzer_registry", "run_analyzers"]

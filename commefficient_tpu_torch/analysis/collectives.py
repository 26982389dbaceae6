"""collective-axis: every collective goes through a counted group of
``parallel/mesh.py``, names its group, and names no peer by a literal
(the reference's ``analysis/collectives.py`` read for torch).

In the port every byte that crosses between devices moves through one
of ``parallel/mesh.py``'s group objects (``DistributedWorkers``, one per
axis of the (workers, model, seq) grid). Each of their methods counts
its call in the group's ``CollectiveCounter`` before it calls
``torch.distributed``: that count is what ``telemetry/round_audit.py``
holds the bytes of a round against, what the ledger's ``comm/*``
columns and ``perf_report.json``'s collective block report. A
``dist.all_reduce`` written anywhere else moves bytes that no counter
sees; one written without ``group=`` runs over the default (whole
world) group, which on a (workers x model x seq) grid reduces over the
wrong ranks silently; a literal peer (``dst=1``) is valid for exactly
one group size.

Flagged:

  * a ``torch.distributed`` collective or point-to-point call
    (``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
    ``reduce_scatter``, ``reduce_scatter_tensor``, ``broadcast``,
    ``reduce``, ``gather``, ``scatter``, ``all_to_all``,
    ``all_to_all_single``, ``send``, ``recv``, ``isend``, ``irecv``,
    ``batch_isend_irecv``, ``P2POp``) outside a method of a class of
    ``parallel/mesh.py`` that owns a ``CollectiveCounter`` (``self.counter
    = CollectiveCounter()``) — the counted group methods;
  * such a call (but ``batch_isend_irecv``, whose ``P2POp`` items carry
    the group) without an explicit ``group=`` keyword;
  * an integer literal in a peer slot: the ``src=`` / ``dst=`` / ``peer=``
    / ``group_src=`` / ``group_dst=`` / ``group_peer=`` keywords, or the
    positional peer (``send``/``recv``/``isend``/``irecv``'s second
    argument, ``P2POp``'s third, ``broadcast``/``reduce``'s second,
    ``gather``/``scatter``'s third) — peers are computed from the
    group's rank and size, as ``DistributedWorkers.shift`` computes
    ``(rank + step) % size``;
  * a string literal passed as an ``axis_name=`` keyword to ANY call —
    the grid's axes are the declared constants ``WORKERS, MODEL, SEQ``
    (``parallel/mesh.py``), as in the reference.

Declaring the constants (``WORKERS, MODEL, SEQ = "workers", ...``) is an
assignment, not a call, and stays legal.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from commefficient_tpu_torch.analysis.core import (
    Finding,
    PackageIndex,
    dotted_path,
    module_imports,
)

RULE = "collective-axis"
DESCRIPTION = (
    "torch.distributed collectives only in parallel/mesh.py's counted "
    "group methods, with group= and no literal peer; axis names are the "
    "declared constants (WORKERS/MODEL/SEQ)"
)

HOME = "parallel/mesh.py"
COUNTER_CLASS = "CollectiveCounter"

COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
    "all_to_all", "all_to_all_single", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "P2POp",
})
# calls whose group rides on their items instead
NO_GROUP_ARG = frozenset({"batch_isend_irecv"})
PEER_KWARGS = frozenset({"src", "dst", "peer", "group_src", "group_dst",
                         "group_peer"})
# positional index of the peer argument
PEER_POS = {"send": 1, "recv": 1, "isend": 1, "irecv": 1, "P2POp": 2,
            "broadcast": 1, "reduce": 1, "gather": 2, "scatter": 2}


def _collective_name(call: ast.Call, imports: Dict[str, str]) -> Optional[str]:
    """The ``torch.distributed`` function a call names, else None."""
    dotted = dotted_path(call.func, imports)
    if dotted is None:
        return None
    mod, _, name = dotted.rpartition(".")
    if mod == "torch.distributed" and name in COLLECTIVES:
        return name
    return None


def _counted_classes(tree: ast.AST) -> Set[str]:
    """Classes of the home module whose methods assign ``self.<x> =
    CollectiveCounter()``: the counted groups."""
    out = set()
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call) \
                    and isinstance(sub.value.func, ast.Name) \
                    and sub.value.func.id == COUNTER_CLASS \
                    and any(isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self" for t in sub.targets):
                out.add(cls.name)
    return out


def _in_counted_method(tree: ast.AST, counted: Set[str]):
    """{id(call node)} of every call that sits in a method of a counted
    class (at any depth inside the method)."""
    inside = set()
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef) and cls.name in counted:
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    inside.update(id(n) for n in ast.walk(item))
    return inside


def _int_literal(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool))


def analyze(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    for sf in index.trees():
        imports = module_imports(sf.tree)
        home_ok = set()
        if sf.rel == HOME:
            home_ok = _in_counted_method(sf.tree, _counted_classes(sf.tree))
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg == "axis_name" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    findings.append(sf.finding(
                        RULE, kw.value.lineno,
                        f"inline axis-name literal {kw.value.value!r} — use "
                        "the declared grid-axis constant "
                        "(parallel.mesh.WORKERS/MODEL/SEQ)",
                    ))
            name = _collective_name(node, imports)
            if name is None:
                continue
            if id(node) not in home_ok:
                findings.append(sf.finding(
                    RULE, node.lineno,
                    f"torch.distributed.{name} outside {HOME}'s counted "
                    "group methods — its bytes reach no CollectiveCounter; "
                    "call a group method (all_reduce_sum, all_gather, "
                    "reduce_scatter, shift, exchange, ...)",
                ))
            if name not in NO_GROUP_ARG and not any(
                    kw.arg == "group" for kw in node.keywords):
                findings.append(sf.finding(
                    RULE, node.lineno,
                    f"torch.distributed.{name} without group= — runs over "
                    "the default (whole-world) group; pass the grid "
                    "group's handle",
                ))
            peers = [kw.value for kw in node.keywords
                     if kw.arg in PEER_KWARGS]
            pos = PEER_POS.get(name)
            if pos is not None and len(node.args) > pos:
                peers.append(node.args[pos])
            for p in peers:
                if _int_literal(p):
                    findings.append(sf.finding(
                        RULE, p.lineno,
                        f"integer literal {p.value!r} as the peer of "
                        f"torch.distributed.{name} — valid for one group "
                        "size only; compute it from the group's rank and "
                        "size",
                    ))
    return findings

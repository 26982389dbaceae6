"""The retrace sentinel of the port's captured rounds (the reference's
``telemetry/xla_audit.py`` ``RetraceSentinel``, for CUDA graphs).

The reference jit-compiles its round, and a change in an argument's
shape, dtype or weak type silently traces and compiles it again. The
port runs its rounds eagerly, except under the scan engine
(``pipeline/scan_engine.py``, ``--scan_rounds K > 1``), which captures a
block of L rounds into one CUDA graph over static buffers. A graph holds
the addresses, shapes and dtypes it was captured with, so an input whose
signature changed cannot be replayed: the engine captures the program
again, which is the port's retrace. The sentinel records one signature
per capture (the shapes, dtypes and devices of the state leaves and the
staged block inputs, and the block length), one stream per program name
(``round_scan_fn[xL]``): a program's first capture is expected, every
later one is a retrace. ``retraces`` sums ``captures - 1`` over the
programs; with ``max_retraces`` set, going over it raises
``RetraceError`` naming the signature diff. ``xla/retraces`` (the
reference's name) rides every round's metrics at telemetry level >= 1,
0.0 on the per-round path, which captures nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


class RetraceError(RuntimeError):
    """A program was captured again more than ``max_retraces`` times; the
    message names the signature diff that caused the last re-capture."""


def _describe_leaf(x) -> str:
    if torch.is_tensor(x):
        dtype = str(x.dtype).removeprefix("torch.")
        return f"{dtype}[{','.join(map(str, x.shape))}]@{x.device}"
    return f"py:{type(x).__name__}={x!r}"


def _flatten(prefix: str, x, out: Dict[str, str]) -> None:
    if isinstance(x, dict):
        for k in sorted(x):
            _flatten(f"{prefix}[{k!r}]", x[k], out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _flatten(f"{prefix}[{i}]", v, out)
    else:
        out[prefix] = _describe_leaf(x)


def describe_signature(args, kwargs=None) -> Dict[str, str]:
    """``{path: "dtype[shape]@device"}`` over every leaf of one capture's
    inputs (dicts and sequences are walked; a non-tensor leaf is
    described by its type and value): what the
    sentinel compares between two captures of one program."""
    out: Dict[str, str] = {}
    _flatten("args", tuple(args), out)
    if kwargs:
        _flatten("kwargs", dict(kwargs), out)
    return out


def signature_diff(old: Dict[str, str], new: Dict[str, str]) -> str:
    """The leaves that differ between two signatures, one a line (``+``
    added, ``-`` gone, ``~`` changed)."""
    lines = []
    for k in sorted(set(old) | set(new)):
        a, b = old.get(k), new.get(k)
        if a == b:
            continue
        if a is None:
            lines.append(f"  + {k}: {b}")
        elif b is None:
            lines.append(f"  - {k}: {a}")
        else:
            lines.append(f"  ~ {k}: {a} -> {b}")
    return "\n".join(lines) if lines else "  (structure changed)"


class RetraceSentinel:
    """Counts the captures of the session's round programs, one signature
    stream a program name, and names what changed."""

    def __init__(self, max_retraces: Optional[int] = None):
        self.max_retraces = max_retraces
        self.signatures: Dict[str, list] = {}  # name -> [signature, ...]
        self._last_retraced: Optional[str] = None

    @property
    def traces(self) -> int:
        """Captures recorded, expected ones included."""
        return sum(len(v) for v in self.signatures.values())

    @property
    def retraces(self) -> int:
        return sum(max(0, len(v) - 1) for v in self.signatures.values())

    def last_diff(self) -> str:
        name = self._last_retraced
        sigs = self.signatures.get(name, [])
        if len(sigs) < 2:
            return "(no retrace recorded)"
        return f"[{name}]\n" + signature_diff(sigs[-2], sigs[-1])

    def note(self, fn_name: str, signature: Dict[str, Any]) -> None:
        """Record one capture of ``fn_name`` with ``signature``
        (``describe_signature``'s); a second capture of the same name is a
        retrace, and past ``max_retraces`` this raises ``RetraceError``."""
        sigs = self.signatures.setdefault(fn_name, [])
        sigs.append(dict(signature))
        if len(sigs) > 1:
            self._last_retraced = fn_name
        if self.max_retraces is not None and \
                self.retraces > self.max_retraces:
            raise RetraceError(
                f"{fn_name} captured again — {self.retraces} retrace(s) "
                f"total, over the --max_retraces {self.max_retraces} "
                "budget. A re-capture records the whole block of rounds "
                "anew into a new graph and memory pool. Offending "
                "signature diff against the previous capture:\n"
                f"{self.last_diff()}\n"
                "Typical causes: a state leaf replaced by one of another "
                "dtype, shape or device (a restore from another layout), "
                "or a staged input of another dtype.")


__all__ = ["RetraceError", "RetraceSentinel", "describe_signature",
           "signature_diff"]

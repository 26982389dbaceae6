"""The divergence flight recorder (the port's copy of the reference's
``telemetry/flight.py``).

A ring of the last ``cfg.flight_window`` DRAINED round records (step, lr,
every scalar of the round) beside the run's metadata. When a drained
round's loss or its ``diag/nonfinite`` sentinel is non-finite, ``check``
dumps ``flight_<step>.json`` into the run dir and raises
``DivergenceError`` naming that round, the first bad one: rounds drain in
step order, at most one drain interval (an epoch, or a checkpoint
boundary) behind the rounds dispatched, and the ring keeps the rounds
before it. Any other crash of the train loop dumps the ring too
(``on_exception``).

Every artifact is strict JSON: a non-finite float anywhere becomes the
marker ``"nan"``, ``"inf"`` or ``"-inf"`` (``jsonable_scalar``), which the
reference's ``scripts/check_telemetry_schema.py`` accepts. A run of the
control plane attaches its ``BudgetController`` (``controller``), and
every dump then carries its ``controller`` block (policy, rung, switches,
the budget left). A run with resilience/'s recovery attaches its
``ResilienceRider`` (``resilience``, set by ``build_resilience``): every
dump after a recovery carries its ``recovery_history`` block, and a
rollback drops the rolled-back rounds from the ring (``rewind``).
``FleetShrinkError``, a ``DivergenceError``, is the elastic fleet's
unscheduled loss (chaos ``shrink@W'``): the session raises it before the
round's dispatch, and resilience/ heals it as it heals a divergence.
"""

from __future__ import annotations

import json
import math
import os
from collections import deque
from typing import Optional


class DivergenceError(RuntimeError):
    """Training produced a non-finite signal; ``step`` is the first bad
    round, ``path`` the flight record dumped for it."""

    def __init__(self, step: int, reason: str, path: Optional[str]):
        self.step = step
        self.reason = reason
        self.path = path
        where = f"; flight record: {path}" if path else ""
        super().__init__(
            f"non-finite training signal first detected at round {step} "
            f"({reason}){where}. Common causes: lr_scale too high for the "
            "mode, sketch d/c outside the stable envelope (see the "
            "FederatedSession warning / parallel/envelope.py), or "
            "momentum_dampening combinations the config docs flag as "
            "divergent. The flight record holds the last rounds' diag/* "
            "norms: a blowing-up diag/ef_residual_norm implicates the "
            "error-feedback loop; a clean trajectory ending in one bad "
            "round implicates the data/batch at that step.")


class FleetShrinkError(DivergenceError):
    """An unscheduled worker loss (the chaos ``shrink@W'`` fleet event):
    the fleet goes on at ``fleet_width`` < ``prev_width`` workers, and the
    round's cohort is lost before it ran.

    A ``DivergenceError``, so the resilience manager's recovery takes it
    as it is (a rollback to the newest vault snapshot, then the replay,
    which runs at the shrunk width without raising). Its message is its
    own (a shrink is no numerical blow-up), so the base constructor is
    bypassed."""

    def __init__(self, step: int, fleet_width: int, prev_width: int):
        self.step = int(step)
        self.fleet_width = int(fleet_width)
        self.prev_width = int(prev_width)
        self.reason = (f"fleet shrank {prev_width} -> {fleet_width} "
                       f"workers at round {step}")
        self.path = None
        RuntimeError.__init__(
            self,
            f"{self.reason}: the in-flight cohort is lost. With a "
            "resilience policy configured (--recover_policy retry|demote) "
            "the run rolls back to the newest vault snapshot and "
            f"re-enters at width {fleet_width}; replayed rounds bill "
            "exactly once (the ledger rewinds with the rollback).")


def jsonable_scalar(v):
    """A scalar as strict JSON: a float, or ``"nan"``/``"inf"``/``"-inf"``
    for a non-finite one (``json.dump`` would write a bare NaN token that
    strict parsers reject, and a diverging run is exactly when these files
    carry one)."""
    f = float(v)
    if math.isnan(f):
        return "nan"
    if math.isinf(f):
        return "inf" if f > 0 else "-inf"
    return f


def jsonable_tree(obj):
    """``jsonable_scalar`` applied to every float in nested dicts, lists
    and tuples (config snapshots, metadata). Every artifact writer dumps
    with ``allow_nan=False`` after this pass, so a miss fails at write
    time rather than leaving a corrupt file."""
    if isinstance(obj, dict):
        return {k: jsonable_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable_tree(v) for v in obj]
    if isinstance(obj, float):
        return jsonable_scalar(obj)
    return obj


class FlightRecorder:
    """Ring of drained round records, and the crash and divergence dumper.

    Built by the train loop at ``telemetry_level >= 1``; a falsy ``logdir``
    keeps the ring and the checks but writes nothing (the ranks other than
    0 of a worker group). ``record`` appends a drained round; ``check``
    raises ``DivergenceError`` (after the dump) when that round is bad;
    ``on_exception`` dumps the ring for any other crash."""

    def __init__(self, cfg=None, logdir: str = "",
                 window: Optional[int] = None,
                 extra_meta: Optional[dict] = None, controller=None):
        from commefficient_tpu_torch.telemetry.ledger import run_metadata

        self.logdir = logdir
        self.window = int(window if window is not None
                          else getattr(cfg, "flight_window", 16))
        self.meta = run_metadata(cfg, extra_meta)
        self.records: deque = deque(maxlen=self.window)
        self.last_step: Optional[int] = None
        # the control plane's controller and resilience/'s rider (None
        # without them; build_resilience attaches the rider)
        self.controller = controller
        self.resilience = None

    def rewind(self, step: int) -> None:
        """Drop the records at and after ``step`` (a rollback to ``step``),
        so the replayed rounds record in step order again."""
        kept = [r for r in self.records if r["step"] < int(step)]
        self.records = deque(kept, maxlen=self.window)
        self.last_step = kept[-1]["step"] if kept else None

    def record(self, step: int, lr: float, scalars: dict) -> None:
        self.last_step = int(step)
        self.records.append({
            "step": int(step),
            "lr": jsonable_scalar(lr),
            "scalars": {k: jsonable_scalar(v) for k, v in scalars.items()},
        })

    def check(self, step: int, loss: float, scalars: dict) -> None:
        """Raise ``DivergenceError`` iff this drained round is bad: a
        non-finite loss, or the sentinel ``diag/nonfinite`` reporting a
        non-finite norm or parameter. Called in step order, so the first
        raise names the first bad round."""
        reasons = []
        if not math.isfinite(float(loss)):
            reasons.append(f"loss={float(loss)}")
        sentinel = float(scalars.get("diag/nonfinite", 0.0))
        if sentinel > 0.0 or not math.isfinite(sentinel):
            reasons.append("diag/nonfinite sentinel fired (non-finite "
                           "norm or parameter in the round)")
        if not reasons:
            return
        path = self.dump(step, reason="; ".join(reasons), first_bad_step=step)
        raise DivergenceError(int(step), "; ".join(reasons), path)

    def on_exception(self, exc: BaseException) -> Optional[str]:
        """Dump the ring for a crash of the train loop that is not a
        divergence; returns the dump's path."""
        step = self.last_step if self.last_step is not None else -1
        return self.dump(step, reason=f"uncaught {type(exc).__name__}: "
                                      f"{exc}"[:500], first_bad_step=None)

    def dump(self, step: int, *, reason: str, first_bad_step: Optional[int],
             tag: str = "") -> Optional[str]:
        """Write ``flight_<step><tag>.json``; None without a logdir."""
        if not self.logdir:
            return None
        from commefficient_tpu_torch.telemetry import SCHEMA_VERSION

        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"flight_{int(step)}{tag}.json")
        payload = {
            "schema_version": SCHEMA_VERSION,
            "reason": reason,
            "first_bad_step": first_bad_step,
            "window": self.window,
            "meta": self.meta,
            "records": list(self.records),
        }
        # fedsim runs: the [step, participation_rate] window top-level ("did
        # the cohort thin out before the blow-up?")
        hist = [[r["step"], r["scalars"]["fedsim/participation_rate"]]
                for r in self.records
                if "fedsim/participation_rate" in r["scalars"]]
        if hist:
            payload["participation_history"] = hist
        if self.controller is not None:
            payload["controller"] = self.controller.snapshot()
        if self.resilience is not None and self.resilience.history:
            payload["recovery_history"] = list(self.resilience.history)
        with open(path, "w") as f:
            json.dump(jsonable_tree(payload), f, indent=2, allow_nan=False)
        return path

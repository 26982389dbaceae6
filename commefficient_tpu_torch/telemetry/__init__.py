"""Round telemetry of the port (the reference's ``telemetry/``).

The round's own riders (ROADMAP A12a):

* ``diagnostics``: the ``diag/*`` health scalars (aggregate, update and
  error-feedback norms, compressor fidelity at level 2, a non-finite
  sentinel), computed in the round on the round's device and returned
  with its metrics, read back only at the deferred drain;
* ``ledger``: per-round and cumulative uplink and downlink bytes from the
  compressor's accounting, the ``comm/*`` scalars and
  ``comm_ledger.json``;
* ``flight``: a ring of the last drained rounds; a non-finite round dumps
  ``flight_<step>.json`` and raises ``DivergenceError`` naming the first
  bad round, and any other crash of the train loop dumps the ring.

And the host's view of the round (ROADMAP A12b):

* ``spans``: ``PhaseSpans``, the host phases (data wait, fedsim
  environment, device_put, round dispatch, metric drain, checkpoint, the
  prefetch lane) as Chrome-trace events, ``spans_<step>.json``;
* ``trace``: round trace ids, ``CriticalPath`` (each round's wall clock
  split into exclusive stages), the lagged ``trace/*`` scalars,
  ``run_report.json`` and the ``--profile_rounds`` window on
  ``torch.profiler``;
* ``round_audit``: the first dispatched round's FLOPs (matmul and conv),
  peak memory and worker-group collectives, cross-checked against the
  ledger, in ``perf_report.json``, and the ``xla/exposed_collective_ms``
  gate (the reference's schema names, measured here from spans and the
  group's calls).

Levels (``--telemetry_level``):

  0  off (the default): nothing is built and the round runs what it ran
     before, launch for launch.
  1  health: ``diag/*`` norms and the sentinel, ``comm/*``, the flight
     recorder; with a metrics writer also the spans, ``trace/*``,
     ``xla/exposed_collective_ms``, ``pipeline/*`` at depth > 0, and the
     run and perf reports. A few reductions a round (the sketch mode's two
     AMS estimates are K3 launches); the host side launches nothing.
  2  + fidelity: the sketch round trip (``compact_nonzero`` of the
     update, ``sketch_sparse`` through K1, ``estimate_at`` through K4's
     index form) and powersgd's reconstruction residual.

Not ported: the retrace sentinel (``max_retraces``): the port compiles no
round, so there is nothing to retrace; its counterpart is a re-capture of
a CUDA-graph round (ROADMAP A11).
"""

import os

from commefficient_tpu_torch.telemetry.diagnostics import (
    nonfinite_sentinel,
    round_diagnostics,
    round_diagnostics_sparse,
    table_sqnorm_estimate,
)
from commefficient_tpu_torch.telemetry.flight import (
    DivergenceError,
    FlightRecorder,
    jsonable_scalar,
    jsonable_tree,
)
from commefficient_tpu_torch.telemetry.ledger import CommLedger, run_metadata
from commefficient_tpu_torch.telemetry.round_audit import (
    RoundAudit,
    RoundAuditArm,
    chip_peak_flops,
    exposed_collective_ms,
)
from commefficient_tpu_torch.telemetry.spans import PhaseSpans

# telemetry/trace.py's names, imported at first use: the package must not
# import the module itself, or `python -m
# commefficient_tpu_torch.telemetry.trace` finds it imported already
_TRACE_NAMES = ("STAGES", "CriticalPath", "ProfilerStack", "ProfilerWindow",
                "build_run_report", "cohort_trace_id", "round_trace_id",
                "trace_round_scalars", "write_run_report")


def __getattr__(name):
    if name in _TRACE_NAMES:
        from commefficient_tpu_torch.telemetry import trace

        return getattr(trace, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# the reference's artifact schema version (metrics.jsonl headers,
# flight_*.json, comm_ledger.json), so its scripts/check_telemetry_schema.py
# validates the port's run dirs as they are
SCHEMA_VERSION = 13

TELEMETRY_LEVELS = (0, 1, 2)


def run_artifacts(cfg, logdir: str) -> dict:
    """The artifact links of the run header and the flight metadata: the
    ``StepProfiler``'s trace dir when one is set, and at level >= 1 the
    ``perf_report.json`` and ``run_report.json`` the run will write
    (unless ``perf_audit`` / ``run_report`` is off). A report whose write
    later fails leaves its path absent: stat before reading."""
    out = {}
    if getattr(cfg, "profile_dir", ""):
        out["profile_dir"] = cfg.profile_dir
    if (logdir and getattr(cfg, "telemetry_level", 0) >= 1
            and getattr(cfg, "perf_audit", True)):
        out["perf_report"] = os.path.join(logdir, "perf_report.json")
    if (logdir and getattr(cfg, "telemetry_level", 0) >= 1
            and getattr(cfg, "run_report", True)):
        out["run_report"] = os.path.join(logdir, "run_report.json")
    return out


def build_telemetry_riders(cfg, session, writer):
    """``(ledger, flight)`` for a train loop, or ``(None, None)`` below
    level 1 or without a writer: the one construction both entry points
    share. ``session`` is duck-typed (``bytes_per_round()``,
    ``grad_size``, ``group.size``, ``compressor``, and on a compression
    ladder ``rungs``, ``rung_bytes_per_round(i)`` and ``controller``)."""
    if getattr(cfg, "telemetry_level", 0) < 1 or writer is None:
        return None, None
    # a compression ladder's run bills each drained round at the rung its
    # control/rung scalar names; one rung keeps the flat accounting
    rungs = None
    session_rungs = getattr(session, "rungs", None)
    if session_rungs is not None and len(session_rungs) > 1:
        rungs = [(session.rung_bytes_per_round(i), r.compressor)
                 for i, r in enumerate(session_rungs)]
    ledger = CommLedger(session.bytes_per_round(), mode=cfg.mode,
                        num_workers=cfg.num_workers,
                        masked=bool(getattr(cfg, "fedsim_enabled", False)),
                        compressor=getattr(session, "compressor", None),
                        rungs=rungs)
    flight = FlightRecorder(
        cfg, logdir=writer.logdir,
        extra_meta={"grad_size": session.grad_size,
                    "mesh": {"workers": session.group.size},
                    "artifacts": run_artifacts(cfg, writer.logdir)},
        # the dump's controller block: the controller is attached to the
        # session before the riders are built
        controller=getattr(session, "controller", None))
    return ledger, flight


def build_perf_observability(cfg, session, writer, generated_by: str):
    """``(spans, audit_arm)`` for a train loop, or ``(None, None)`` below
    level 1 or without a writer: the one construction both entry points
    share. Attaches a ``PhaseSpans`` to ``session.spans`` and, unless
    ``cfg.perf_audit`` is off, a ``RoundAuditArm`` to
    ``session.audit_arm``: the first round the session dispatches is
    measured and its ``perf_report.json`` written right after it."""
    if getattr(cfg, "telemetry_level", 0) < 1 or writer is None:
        return None, None
    spans = PhaseSpans(writer.logdir)
    session.spans = spans
    arm = None
    if getattr(cfg, "perf_audit", True):
        arm = RoundAuditArm(session, cfg, writer, generated_by)
        session.audit_arm = arm
    return spans, arm


def record_crash(flight, exc) -> None:
    """The train loop's except hook: dump the ring for a crash that is
    NOT a divergence (a divergence dumped its own record at the drain).
    Nothing without a flight recorder."""
    if flight is not None and not isinstance(exc, DivergenceError):
        flight.on_exception(exc)


__all__ = [
    "SCHEMA_VERSION",
    "STAGES",
    "TELEMETRY_LEVELS",
    "CommLedger",
    "CriticalPath",
    "DivergenceError",
    "FlightRecorder",
    "PhaseSpans",
    "ProfilerStack",
    "ProfilerWindow",
    "RoundAudit",
    "RoundAuditArm",
    "build_perf_observability",
    "build_run_report",
    "build_telemetry_riders",
    "chip_peak_flops",
    "cohort_trace_id",
    "exposed_collective_ms",
    "jsonable_scalar",
    "jsonable_tree",
    "nonfinite_sentinel",
    "record_crash",
    "round_diagnostics",
    "round_diagnostics_sparse",
    "round_trace_id",
    "run_artifacts",
    "run_metadata",
    "table_sqnorm_estimate",
    "trace_round_scalars",
    "write_run_report",
]

"""Round telemetry of the port (the reference's ``telemetry/``, the part
that needs no host spans; ROADMAP A12a).

Three pillars, as in the reference:

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

Levels (``--telemetry_level``):

  0  off (the default): nothing is built and the round runs what it ran
     before, launch for launch.
  1  health: ``diag/*`` norms and the sentinel, ``comm/*``, the flight
     recorder. A few reductions a round (the sketch mode's two AMS
     estimates are K3 launches).
  2  + fidelity: the sketch round trip (``compact_nonzero`` of the
     update, ``sketch_sparse`` through K1, ``estimate_at`` through K4's
     index form) and powersgd's reconstruction residual.

Not ported yet (ROADMAP A12b): the host spans, trace ids and
``run_report.json``, the profiler window of ``--profile_rounds``, and the
compiled-round audit with its ``perf_report.json`` and ``xla/*`` scalars
(nothing in the port is traced, so no ``xla/*`` scalar exists).
"""

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

# the reference's artifact schema version (metrics.jsonl headers,
# flight_*.json, comm_ledger.json), so its scripts/check_telemetry_schema.py
# validates the port's run dirs as they are
SCHEMA_VERSION = 13

TELEMETRY_LEVELS = (0, 1, 2)


def run_artifacts(cfg, logdir: str) -> dict:
    """The artifact links of the run header and the flight metadata: only
    what the port writes, the ``StepProfiler``'s trace dir when one is
    set (the reference's ``perf_report`` and ``run_report`` links wait for
    ROADMAP A12b)."""
    out = {}
    if getattr(cfg, "profile_dir", ""):
        out["profile_dir"] = cfg.profile_dir
    return out


def build_telemetry_riders(cfg, session, writer):
    """``(ledger, flight)`` for a train loop, or ``(None, None)`` below
    level 1 or without a writer: the one construction both entry points
    share. ``session`` is duck-typed (``bytes_per_round()``,
    ``grad_size``, ``group.size``, ``compressor``)."""
    if getattr(cfg, "telemetry_level", 0) < 1 or writer is None:
        return None, None
    ledger = CommLedger(session.bytes_per_round(), mode=cfg.mode,
                        num_workers=cfg.num_workers,
                        masked=bool(getattr(cfg, "fedsim_enabled", False)),
                        compressor=getattr(session, "compressor", None))
    flight = FlightRecorder(
        cfg, logdir=writer.logdir,
        extra_meta={"grad_size": session.grad_size,
                    "mesh": {"workers": session.group.size},
                    "artifacts": run_artifacts(cfg, writer.logdir)})
    return ledger, flight


def record_crash(flight, exc) -> None:
    """The train loop's except hook: dump the ring for a crash that is
    NOT a divergence (a divergence dumped its own record at the drain).
    Nothing without a flight recorder."""
    if flight is not None and not isinstance(exc, DivergenceError):
        flight.on_exception(exc)


__all__ = [
    "SCHEMA_VERSION",
    "TELEMETRY_LEVELS",
    "CommLedger",
    "DivergenceError",
    "FlightRecorder",
    "build_telemetry_riders",
    "jsonable_scalar",
    "jsonable_tree",
    "nonfinite_sentinel",
    "record_crash",
    "round_diagnostics",
    "round_diagnostics_sparse",
    "run_artifacts",
    "run_metadata",
    "table_sqnorm_estimate",
]

"""Round trace ids, critical-path attribution, the run report and the
``--profile_rounds`` window (the port's copy of
``commefficient_tpu/telemetry/trace.py``). Pure host code: nothing here
touches a round's values.

**Trace ids.** Every round gets the id ``round_trace_id(step) ==
"r<step>"``, minted where its inputs are realized; the prefetch lane
(sampler draw, fedsim environment, H2D stage) and the dispatch plane
(device_put, round dispatch, metric drain) stamp their spans with it, so
a Perfetto dump links a round's work across lanes. The ids are
deterministic: twin runs mint the same ones.

**CriticalPath.** Interval arithmetic over the recorded spans splits each
round's wall clock into EXCLUSIVE stage times (``STAGES``): ``data``
(sampler draw, fedsim environment, the data wait), ``h2d`` (device_put,
prefetch stage), ``dispatch`` (the round's dispatch), ``collective`` (the
part of collective-tagged spans no other span covers), ``drain`` (metric
drain, checkpoint), ``writeback`` (the reference's hosted client rows;
0 here) and ``idle`` (wall clock no span covers). Each stage's union is
clipped to the round's window minus what higher-priority stages took
(collective, drain, writeback, dispatch, h2d, data), so the stage times
are disjoint and sum to the round's wall clock; the critical stage is the
largest. At telemetry level >= 1 each round's metrics carry
``trace/critical_stage`` (the index into ``STAGES``) and
``trace/<stage>_exclusive_ms``, LAGGED: the scalars of round N describe
round N-2, the newest round whose spans are complete then (N-1 has just
dispatched; its drain has not run). Earlier rounds carry the zeros row.

**Run report and profiler window.** ``build_run_report(run_dir)`` turns
a run dir (spans dump, ``metrics.jsonl``, flight records,
``perf_report.json``) into ``run_report.json``: per-stage p50/p95,
fractions summing to 1, anomaly flags (stall spikes, staleness drift,
cache-hit collapse). The train loop writes it at close when
``cfg.run_report``; ``python -m commefficient_tpu_torch.telemetry.trace
RUN_DIR [...] [--out NAME]`` writes it for finished runs.
``ProfilerWindow`` traces ``--profile_rounds A-B`` (inclusive) with
``torch.profiler`` (CPU and, on the card, CUDA activities) into a
directory of Chrome traces, clamped to ``MIN_WARMUP_STEPS``, fenced at
entry and exit; a start that cannot trace (another ``torch.profiler``
session already running, as an overlapping ``--profile_dir`` window)
disarms the window with a named message and the run goes on.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

# Exclusive-stage taxonomy, in report order. ``trace/critical_stage``
# is emitted as the INDEX into this tuple (scalar streams are numeric);
# reports and bench rows carry the name. Order is part of the schema —
# append-only.
STAGES: Tuple[str, ...] = (
    "data", "h2d", "dispatch", "collective", "drain", "writeback", "idle",
)

# Priority order for exclusive assignment (idle is always the remainder).
# Exposed collective first — it is the scarce signal the overlap work
# exists to shrink; then the post-dispatch phases, then the
# producer phases. A microsecond covered by two spans is charged to the
# highest-priority stage only.
_PRIORITY: Tuple[str, ...] = (
    "collective", "drain", "writeback", "dispatch", "h2d", "data",
)

# span name -> stage. Unknown span names still shape the round window
# and cover collective exposure, but are not charged to a named stage
# (their uncovered time lands in idle) — forward-compatible with new
# span sites.
_SPAN_STAGE: Dict[str, str] = {
    "data_load": "data",
    "prefetch_realize": "data",
    "fedsim_env": "data",
    "device_put": "h2d",
    "prefetch_stage": "h2d",
    "clientstore_gather": "h2d",
    "round_dispatch": "dispatch",
    "async_launch": "dispatch",
    "async_apply": "dispatch",
    "async_apply_dispatch": "dispatch",
    "async_apply_drain": "drain",
    "metric_drain": "drain",
    "checkpoint": "drain",
    "snapshot": "drain",
    "clientstore_writeback": "writeback",
    "clientstore_flush": "writeback",
}

# spans recorded for Perfetto correlation only, never path analysis: a
# cohort's buffer residency OVERLAPS several rounds by design — letting
# it shape a round's window (or cover collective exposure) would charge
# wall-clock that was never serial
_NON_PATH_SPANS = frozenset({"async_buffer_residency"})


# ---------------------------------------------------------------------------
# trace ids
# ---------------------------------------------------------------------------
def round_trace_id(step: int) -> str:
    """The round's trace id (``r<step>``) — the root of its causal tree.
    Deterministic on purpose: twin runs mint identical ids."""
    return f"r{int(step)}"


def cohort_trace_id(cohort: int) -> str:
    """An async cohort's trace id (``c<cohort>``); its ``parent`` is
    ``round_trace_id`` of the server round that launched it."""
    return f"c{int(cohort)}"


def step_of_trace_id(trace_id) -> Optional[int]:
    """``"r<step>"`` -> the round index, else None. Span sites that only
    receive a trace id (the clientstore streamer — it does not know the
    round clock) recover the owning step for their events this way; the
    deterministic id format makes it total on round ids."""
    if isinstance(trace_id, str) and trace_id[:1] == "r":
        try:
            return int(trace_id[1:])
        except ValueError:
            return None
    return None


# ---------------------------------------------------------------------------
# interval arithmetic (us since recorder epoch, [a, b) half-open)
# ---------------------------------------------------------------------------
def _union(ivs: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _subtract(ivs, cover) -> List[List[float]]:
    """``union(ivs) - union(cover)`` as a sorted disjoint interval list."""
    out: List[List[float]] = []
    cover = _union(cover)
    for a, b in _union(ivs):
        cur = a
        for ca, cb in cover:
            if cb <= cur:
                continue
            if ca >= b:
                break
            if ca > cur:
                out.append([cur, ca])
            cur = max(cur, cb)
            if cur >= b:
                break
        if cur < b:
            out.append([cur, b])
    return out


def _clip(ivs, lo: float, hi: float) -> List[List[float]]:
    return [[max(a, lo), min(b, hi)] for a, b in ivs
            if min(b, hi) > max(a, lo)]


def _total(ivs) -> float:
    return sum(b - a for a, b in ivs)


# ---------------------------------------------------------------------------
# per-round critical-path decomposition
# ---------------------------------------------------------------------------
class CriticalPath:
    """Decompose rounds' wall-clock into exclusive stage times from a
    sequence of Chrome-trace "X" events (a ``PhaseSpans`` ring or a
    loaded spans dump). Pure interval arithmetic; see the module
    docstring for the assignment rules."""

    def __init__(self, events: Sequence[dict]):
        # bucket once by round: analyzers ask for many rounds
        self._by_step: Dict[int, List[dict]] = {}
        for ev in events:
            if ev.get("ph") != "X" or ev.get("name") in _NON_PATH_SPANS:
                continue
            try:
                step = int(ev.get("args", {}).get("step"))
            except (TypeError, ValueError):
                continue
            self._by_step.setdefault(step, []).append(ev)

    def steps(self) -> List[int]:
        return sorted(self._by_step)

    def round_breakdown(self, step: int) -> Optional[dict]:
        """``{"step", "wall_ms", "critical_stage", "stages_ms": {...}}``
        for one round, or None when no spans carry that step. Stage
        times are disjoint and sum to exactly ``wall_ms``."""
        evs = self._by_step.get(int(step))
        if not evs:
            return None
        ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in evs]
        lo = min(a for a, _ in ivs)
        hi = max(b for _, b in ivs)
        coll, comp = [], []
        by_stage: Dict[str, List[Tuple[float, float]]] = {}
        for ev, iv in zip(evs, ivs):
            if ev.get("args", {}).get("collective"):
                coll.append(iv)
            else:
                comp.append(iv)
            stage = _SPAN_STAGE.get(ev.get("name"))
            if stage is not None:
                by_stage.setdefault(stage, []).append(iv)
        stages_ms = {s: 0.0 for s in STAGES}
        # exposed collective: collective-tagged time no compute span
        # covers (collective_exposure_ms, per round)
        assigned = _clip(_subtract(coll, comp), lo, hi)
        stages_ms["collective"] = _total(assigned) / 1e3
        for stage in _PRIORITY:
            if stage == "collective":
                continue
            excl = _subtract(_clip(by_stage.get(stage, []), lo, hi),
                             assigned)
            stages_ms[stage] = _total(excl) / 1e3
            assigned = _union(assigned + excl)
        wall_ms = (hi - lo) / 1e3
        stages_ms["idle"] = max(0.0, wall_ms - _total(assigned) / 1e3)
        critical = max(STAGES, key=lambda s: stages_ms[s])
        return {"step": int(step), "wall_ms": wall_ms,
                "critical_stage": critical, "stages_ms": stages_ms}


def trace_scalar_keys() -> List[str]:
    """The constant ``trace/*`` scalar key set (schema v11)."""
    return ["trace/critical_stage"] + [
        f"trace/{s}_exclusive_ms" for s in STAGES
    ]


def trace_round_scalars(spans, step: int) -> Dict[str, float]:
    """The per-round ``trace/*`` scalars for round ``step`` from a live
    ``PhaseSpans`` ring — constant key set; zeros (critical_stage
    pinned to the idle index) when the round has no spans yet, so the
    lagged emission's first rounds keep pack_metric_dicts happy."""
    zeros = {k: 0.0 for k in trace_scalar_keys()}
    zeros["trace/critical_stage"] = float(STAGES.index("idle"))
    if spans is None or step < 0:
        return zeros
    # the round's own events (PhaseSpans.events_of), not the whole ring:
    # CriticalPath buckets by step, so the breakdown is the same
    bd = CriticalPath(spans.events_of(step)).round_breakdown(step)
    if bd is None:
        return zeros
    out = {"trace/critical_stage":
           float(STAGES.index(bd["critical_stage"]))}
    for s in STAGES:
        out[f"trace/{s}_exclusive_ms"] = float(bd["stages_ms"][s])
    return out


# ---------------------------------------------------------------------------
# run report
# ---------------------------------------------------------------------------
def _percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (no interpolation — stable for tiny N)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return float(xs[i])


def _read_metrics_series(path: str) -> Dict[str, List[float]]:
    """metrics.jsonl -> name -> values in step order (header rows and
    stringified non-finites skipped — anomaly detection wants clean
    series, the schema checker owns strictness)."""
    series: Dict[str, List[Tuple[int, float]]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            name, val = rec.get("name"), rec.get("value")
            if not isinstance(name, str):
                continue
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            series.setdefault(name, []).append(
                (int(rec.get("step", 0)), float(val)))
    return {k: [v for _, v in sorted(vs)] for k, vs in series.items()}


def _detect_anomalies(series: Dict[str, List[float]]) -> List[dict]:
    """Flag the three failure smells the subsystems' scalars expose.
    Thresholds are deliberately coarse — these are triage flags for a
    human, not gates (the checkers own gating)."""
    out: List[dict] = []

    def quarter_means(xs):
        q = max(1, len(xs) // 4)
        return (sum(xs[:q]) / q, sum(xs[-q:]) / q)

    stalls = series.get("pipeline/host_stall_ms", [])
    if len(stalls) >= 8:
        p50, p95 = _percentile(stalls, 0.5), _percentile(stalls, 0.95)
        if p95 > max(5.0 * p50, 1.0):
            out.append({
                "kind": "stall_spike", "metric": "pipeline/host_stall_ms",
                "detail": f"p95 {p95:.2f} ms vs p50 {p50:.2f} ms — "
                          "prefetch is not keeping the pipe fed on some "
                          "rounds (data source or H2D hiccups)",
            })
    stale = series.get("async/staleness_mean", [])
    if len(stale) >= 8:
        first, last = quarter_means(stale)
        if last > 2.0 * first + 0.5:
            out.append({
                "kind": "staleness_drift", "metric": "async/staleness_mean",
                "detail": f"mean staleness drifted {first:.2f} -> "
                          f"{last:.2f} over the run — arrivals are "
                          "falling behind the apply rate",
            })
    hits = series.get("clientstore/cache_hit_rate", [])
    if len(hits) >= 8:
        first, last = quarter_means(hits)
        if first >= 0.2 and last < 0.5 * first:
            out.append({
                "kind": "cache_hit_collapse",
                "metric": "clientstore/cache_hit_rate",
                "detail": f"cache hit rate collapsed {first:.2f} -> "
                          f"{last:.2f} — the cohort working set outgrew "
                          "--client_store_cache_rows",
            })
    return out


def build_run_report(run_dir: str,
                     generated_by: str = "telemetry.trace") -> dict:
    """Assemble the versioned run report for one run directory. Reads
    whatever artifacts exist (spans dump, metrics.jsonl, flight
    records, perf_report.json); raises ``ValueError`` when the
    directory has neither spans nor metrics to analyze."""
    spans_paths = sorted(glob.glob(os.path.join(run_dir, "spans_*.json")))
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    flight_n = len(glob.glob(os.path.join(run_dir, "flight_*.json")))
    perf_path = os.path.join(run_dir, "perf_report.json")
    if not spans_paths and not os.path.exists(metrics_path):
        raise ValueError(
            f"{run_dir}: no spans_*.json and no metrics.jsonl — nothing "
            "to analyze (is this a run directory?)"
        )

    rounds: List[dict] = []
    if spans_paths:
        # the LAST dump is the complete one (a run dumps once at close;
        # earlier files would be from a resumed predecessor)
        with open(spans_paths[-1]) as f:
            dump = json.load(f)
        cp = CriticalPath(dump.get("traceEvents", []))
        # step -1 is the recorder's pre-round clock (warmup compile, the
        # first data load): real wall time, but not an attributable round
        rounds = [bd for bd in (cp.round_breakdown(s)
                                for s in cp.steps() if s >= 0)
                  if bd is not None]

    total_wall = sum(r["wall_ms"] for r in rounds)
    stages_block: Dict[str, dict] = {}
    for s in STAGES:
        xs = [r["stages_ms"][s] for r in rounds]
        tot = sum(xs)
        stages_block[s] = {
            "p50_ms": _percentile(xs, 0.5),
            "p95_ms": _percentile(xs, 0.95),
            "total_ms": tot,
            # fractions sum to 1 across stages (idle is the remainder of
            # every round, so the stage totals sum to the wall total)
            "fraction": (tot / total_wall) if total_wall > 0 else 0.0,
        }
    critical_counts = {s: 0 for s in STAGES}
    for r in rounds:
        critical_counts[r["critical_stage"]] += 1
    critical = (max(STAGES, key=lambda s: critical_counts[s])
                if rounds else "idle")

    series = (_read_metrics_series(metrics_path)
              if os.path.exists(metrics_path) else {})

    from commefficient_tpu_torch.telemetry import SCHEMA_VERSION

    return {
        "schema_version": SCHEMA_VERSION,
        "kind": "run_report",
        "run_dir": run_dir,
        "generated_by": generated_by,
        "sources": {
            "spans": os.path.basename(spans_paths[-1])
                     if spans_paths else None,
            "metrics": os.path.exists(metrics_path),
            "flight_records": flight_n,
            "perf_report": os.path.exists(perf_path),
        },
        "rounds_analyzed": len(rounds),
        "critical_stage": critical,
        "critical_counts": critical_counts,
        "stages": stages_block,
        "rounds": rounds,
        "anomalies": _detect_anomalies(series),
    }


def write_run_report(run_dir: str, generated_by: str) -> Optional[str]:
    """Build + write ``run_report.json`` into ``run_dir``; returns the
    path, or None when the directory has nothing to analyze (never
    raises — this runs in the train loop's close path)."""
    try:
        report = build_run_report(run_dir, generated_by=generated_by)
    except (OSError, ValueError):
        return None
    from commefficient_tpu_torch.telemetry import jsonable_tree

    path = os.path.join(run_dir, "run_report.json")
    try:
        with open(path, "w") as f:
            json.dump(jsonable_tree(report), f, indent=1, allow_nan=False)
    except (OSError, ValueError):  # a failed write must not mask the run's exit
        return None
    return path


# ---------------------------------------------------------------------------
# --profile_rounds capture window
# ---------------------------------------------------------------------------
def parse_profile_rounds(spec: str) -> Tuple[int, int]:
    """``"A-B"`` -> ``(A, B)`` inclusive round window. Config validation
    calls this; raises ``ValueError`` with the offending spec."""
    parts = str(spec).split("-")
    if len(parts) != 2:
        raise ValueError(
            f"profile_rounds must be 'A-B' (inclusive round window), "
            f"got {spec!r}"
        )
    try:
        a, b = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"profile_rounds must be 'A-B' with integer A, B, got {spec!r}"
        ) from None
    if a < 0 or b < a:
        raise ValueError(
            f"profile_rounds needs 0 <= A <= B, got {spec!r}"
        )
    return a, b


class ProfilerWindow:
    """A ``torch.profiler`` capture over ``--profile_rounds A-B``.

    The ``StepProfiler`` protocol (``step`` / ``resume_at`` / ``close``),
    so the runner stacks both behind one ``ProfilerStack``. The start is
    clamped to ``MIN_WARMUP_STEPS`` (a ``0-3`` spec cannot trace the first
    rounds' one-time work) and entry and exit are FENCED through
    ``fence_fn``: the rounds queued before the window finish before the
    trace starts, and the window's rounds before it stops, so the trace
    holds exactly the requested rounds. ``on_trace_ready`` is
    ``tensorboard_trace_handler(logdir)``: a Chrome-trace JSON a window.
    A start that fails (another ``torch.profiler`` session is running:
    torch allows one a process, and a second start would silently end the
    first) disarms the window with a named message instead of stopping
    the run.
    """

    def __init__(self, spec: str, logdir: str, fence_fn=None):
        from commefficient_tpu_torch.utils.profiling import MIN_WARMUP_STEPS

        a, b = parse_profile_rounds(spec)
        self.num_steps = b - a + 1
        self.start = max(a, MIN_WARMUP_STEPS)
        self.stop_at = self.start + self.num_steps
        self.logdir = logdir
        self._fence_fn = fence_fn
        self._prof = None
        self._armed = bool(logdir)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def resume_at(self, resume_step: int) -> None:
        from commefficient_tpu_torch.utils.profiling import MIN_WARMUP_STEPS

        floor = resume_step + MIN_WARMUP_STEPS
        if floor > self.start:
            self.start = floor
            self.stop_at = floor + self.num_steps

    def _fence(self) -> None:
        if self._fence_fn is None:
            return
        try:
            self._fence_fn()
        except Exception as e:  # noqa: BLE001 — a failed sync blurs the edge
            print(f"[profile_rounds] window fence failed "
                  f"({type(e).__name__}: {e}); capture boundary is "
                  f"best-effort", flush=True)

    def _stop(self, when: str = "") -> None:
        prof, self._prof = self._prof, None
        try:
            prof.stop()  # writes the trace through on_trace_ready
        except Exception as e:  # noqa: BLE001 — the run goes on
            print(f"[profile_rounds] stop_trace failed{when} "
                  f"({type(e).__name__}: {e})", flush=True)

    def step(self, step_idx: int) -> None:
        if not self._armed:
            return
        if self.active and step_idx >= self.stop_at:
            self._fence()
            self._stop()
            self._armed = False
        elif not self.active and self.start <= step_idx < self.stop_at:
            self._fence()
            try:
                from commefficient_tpu_torch.utils.profiling import (
                    start_profiler,
                )

                self._prof = start_profiler(self.logdir)
                print(f"[profile_rounds] capturing rounds "
                      f"[{self.start}, {self.stop_at}) -> {self.logdir}",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — the run goes on
                print(f"[profile_rounds] start_trace unavailable on this "
                      f"backend ({type(e).__name__}: {e}); window "
                      f"disarmed", flush=True)
                self._armed = False

    def close(self) -> None:
        if self.active:
            self._fence()
            self._stop(" at close")


class ProfilerStack:
    """Fan one ``step`` / ``resume_at`` / ``close`` stream out to several
    profiler-protocol objects (``StepProfiler`` + ``ProfilerWindow``): the
    round sources keep calling one ``profiler``."""

    def __init__(self, *profilers):
        self.profilers = [p for p in profilers if p is not None]

    def resume_at(self, resume_step: int) -> None:
        for p in self.profilers:
            p.resume_at(resume_step)

    def step(self, step_idx: int) -> None:
        for p in self.profilers:
            p.step(step_idx)

    def close(self) -> None:
        for p in self.profilers:
            p.close()


# ---------------------------------------------------------------------------
# the run-report command
# ---------------------------------------------------------------------------
def _human_lines(report: dict) -> None:
    print(f"{report['run_dir']}: {report['rounds_analyzed']} round(s) "
          f"analyzed, critical stage: {report['critical_stage']}")
    for name, blk in report["stages"].items():
        print(f"  {name:11s} p50 {blk['p50_ms']:9.3f} ms   "
              f"p95 {blk['p95_ms']:9.3f} ms   "
              f"{100.0 * blk['fraction']:5.1f}% of wall")
    for a in report["anomalies"]:
        print(f"  ANOMALY [{a['kind']}] {a['metric']}: {a['detail']}")


def main(argv=None) -> int:
    """``python -m commefficient_tpu_torch.telemetry.trace RUN_DIR
    [RUN_DIR ...] [--out NAME]``: write each run dir's run report
    (``run_report.json``, or ``NAME``) and print its stages. The last
    stdout line is always one JSON object, ``{"kind": "analyze_run",
    "run_dirs": N, "reports": M, "failures": [...]}``; the exit code is 0,
    1 when a run dir failed, 2 for a usage error."""
    argv = list(sys.argv[1:] if argv is None else argv)

    def summary_line(**kw):
        print(json.dumps({"kind": "analyze_run", **kw}))

    out_name = "run_report.json"
    if "--out" in argv:
        i = argv.index("--out")
        if i + 1 >= len(argv):
            print(main.__doc__)
            summary_line(run_dirs=0, reports=0, failures=[],
                         error="--out needs a file name")
            return 2
        out_name = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(main.__doc__)
        summary_line(run_dirs=0, reports=0, failures=[],
                     error="usage: pass one or more run dirs")
        return 2
    from commefficient_tpu_torch.telemetry import jsonable_tree

    rc = 0
    reports = 0
    failures = []
    for run_dir in argv:
        try:
            report = build_run_report(
                run_dir, generated_by="commefficient_tpu_torch.telemetry.trace")
            path = os.path.join(run_dir, out_name)
            with open(path, "w") as f:
                json.dump(jsonable_tree(report), f, indent=1,
                          allow_nan=False)
            _human_lines(report)
            print(f"wrote {path}")
            reports += 1
        except (OSError, ValueError) as e:  # this dir fails, the rest go on
            print(f"FAIL {run_dir}: {e}")
            failures.append(f"{run_dir}: {e}")
            rc = 1
    summary_line(run_dirs=len(argv), reports=reports, failures=failures)
    return rc


if __name__ == "__main__":
    sys.exit(main())

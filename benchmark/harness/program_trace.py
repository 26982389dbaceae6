"""The program's own spans on the device trace: what the host was doing
in each of the device's idle gaps.

A traced run's readers of the idle shares call ``read(ctx)`` after the
harness's own traced window (``bench.profile``). The first call traces
two more windows of ``bench.TRACE_SECONDS`` on the same round source
with ``torch.profiler`` (device activity only, as ``profile``): the
first with no span recorder attached, the second with a detailed,
in-memory ``PhaseSpans`` (``commefficient_tpu_torch/telemetry/spans.py``)
on the session, built with no fenced window (a fence would synchronize
the device inside the trace). The two give the cost of the recorder;
the second gives the readings, cached on ``ctx``. A program whose
``PhaseSpans`` has no detail level reads None, and so does an untraced
run or one on the CPU.

Clocks: the recorder's spans are put on the trace through its
``unix_ns`` (a ``perf_counter``/``time.time_ns`` pair read back to back)
and the profiler's ``trace_start_ns()``; the harness's own host ranges
through a pair of its own. Two cross-checks are reported, in
microseconds: the marker kernel ``profile`` uses (a ``torch.cuda._sleep``
launched on an idle device at a known host time; the profiler keeps it
in a process's first session and loses it in most later ones), and the
end of the window's closing ``cudaDeviceSynchronize`` in CUPTI's runtime
records (on the kernels' clock) against the host's reading as it
returns. Past ``CLOCK_LIMIT_US`` the closing synchronize places the host
times.

Labels: every instant of the window carries the harness's label
(``dispatch``: inside the round source's ``next()``, ``epoch_staging``
where that call staged a scan engine's epoch, ``drain``: the loss
bookkeeping after it, ``host``: anywhere else) and, after a ``/``, the
innermost program span open then: ``gc`` whenever a collection runs (it
holds the interpreter), else the latest started. ``idle_by_label`` sums
the device's idle seconds by label; the idle shares below are percents
of the window, as ``device_idle_share`` is, so a cell's add up.

The harness's ``Context`` carries no round source: the run's own (the
``rounds`` and ``drainer`` of the frame that built ``ctx``,
``bench.run``) is found on the stack."""

from __future__ import annotations

import bisect
import inspect
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.harness.bench import TRACE_SECONDS, _union

CLOCK_LIMIT_US = 100.0
# the round's dispatch and its phases: the host enqueuing the round
ENQUEUE_SPANS = ("round_dispatch", "round.grads", "round.encode",
                 "round.server", "round.apply")
# the harness's ranges inside the round source's next()
SOURCE_LABELS = ("dispatch", "epoch_staging")
GAPS_KEPT = 10


def read(ctx) -> Optional[dict]:
    """The traced readings (``summarize``'s dict), computed once a run
    and kept on ``ctx``; None where there is nothing to read."""
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = _trace(ctx)
    return ctx.program_trace


def _detailed_recorder():
    """The program's ``PhaseSpans`` class if it has a detail level."""
    from commefficient_tpu_torch.telemetry.spans import PhaseSpans

    if "detail" not in inspect.signature(PhaseSpans).parameters:
        return None
    return PhaseSpans


def _round_source(ctx) -> Optional[Tuple]:
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if loc.get("ctx") is ctx and "rounds" in loc and "drainer" in loc:
            return loc["rounds"], loc["drainer"]
        f = f.f_back
    return None


def _trace(ctx) -> Optional[dict]:
    if not ctx.profile or not torch.cuda.is_available():
        return None
    spans_cls = _detailed_recorder()
    src = _round_source(ctx)
    if spans_cls is None or src is None:
        return None
    rounds, drainer = src
    plain = window(ctx.program, rounds, drainer, TRACE_SECONDS, None)
    traced = window(ctx.program, rounds, drainer, TRACE_SECONDS,
                    lambda: spans_cls("", num_steps=0, detail=True))
    out = summarize(traced)
    base = summarize(plain)
    out["plain"] = {k: base[k] for k in
                    ("window_s", "busy_s", "idle_share", "rounds")}
    print("program_trace " + json.dumps(out), file=sys.stderr, flush=True)
    return out


def _pair() -> Tuple[int, int]:
    return time.perf_counter_ns(), time.time_ns()


def window(prog, rounds, drainer, seconds: float, make_recorder) -> dict:
    """``seconds`` of rounds under ``torch.profiler`` (device activity
    only), with the recorder ``make_recorder()`` builds attached to the
    session (None: none). Returns the raw trace on one clock: seconds
    since the profiler's trace start."""
    session = prog.session
    ranges = []
    rec = None
    prev = session.spans
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1)  # the marker
        torch.cuda.synchronize()
        if make_recorder is not None:
            rec = make_recorder()
            session.spans = rec
        pair = _pair()
        try:
            n = 0
            ta = time.perf_counter()
            while time.perf_counter() - ta < seconds:
                a = time.perf_counter()
                s, _, metrics, wait_ms, _ = next(rounds)
                b = time.perf_counter()
                drainer.add(s, metrics)
                c = time.perf_counter()
                staged = wait_ms > 0 and prog.cfg.scan_rounds > 1
                ranges += [(a, b, "epoch_staging" if staged else "dispatch"),
                           (b, c, "drain")]
                n += 1
            torch.cuda.synchronize()
            tb = time.perf_counter()
        finally:
            if rec is not None:
                session.spans = prev
                rec.close()
    start_ns = prof.profiler.kineto_results.trace_start_ns()

    def host(t: float) -> float:  # perf_counter s -> trace s
        return (pair[1] + round(t * 1e9) - pair[0] - start_ns) / 1e9

    kernels, mark, syncs = [], None, []
    for e in prof.events():
        t = e.time_range
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name == "cudaDeviceSynchronize":  # CUPTI's runtime record
                syncs.append(t.end / 1e6)
            continue
        if mark is None and "spin_kernel" in e.name:
            mark = t.start / 1e6
            continue
        kernels.append((t.start / 1e6, t.end / 1e6))
    clock = {"marker_minus_trace_start_us":
             None if mark is None else 1e6 * (mark - host(t_mark)),
             "sync_minus_trace_start_us": None, "used": "trace_start"}
    shift = 0.0
    if syncs:
        # the window's closing synchronize, on the kernels' clock
        end = min(syncs, key=lambda x: abs(x - host(tb)))
        skew = end - host(tb)
        clock["sync_minus_trace_start_us"] = 1e6 * skew
        if abs(skew) * 1e6 > CLOCK_LIMIT_US:
            shift = skew
            clock["used"] = "closing_sync"
    spans = []
    if rec is not None:
        for ev in rec.events:
            a = (rec.unix_ns(ev["ts"]) - start_ns) / 1e9 + shift
            spans.append((a, a + ev["dur"] / 1e6, ev["name"], ev["args"]))
    return {"window": (host(ta) + shift, host(tb) + shift),
            "kernels": [k for k in kernels if mark is None or k[0] > mark],
            "ranges": [(host(a) + shift, host(b) + shift, lab)
                       for a, b, lab in ranges],
            "spans": spans, "rounds": n, "clock": clock}


class _Busy:
    """The device's busy time up to an instant, from merged intervals."""

    def __init__(self, merged: List[List[float]]):
        self.starts = [a for a, _ in merged]
        self.merged = merged
        self.before = [0.0]
        for a, b in merged:
            self.before.append(self.before[-1] + b - a)

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        a, b = self.merged[i - 1]
        return self.before[i - 1] + min(t, b) - a

    def idle(self, a: float, b: float) -> float:
        return (b - a) - (self.upto(b) - self.upto(a))


def _innermost(spans, t: float) -> Optional[str]:
    """The program span open at ``t``: ``gc`` if a collection is, else
    the latest started (the shortest of a tie)."""
    best = None
    for a, b, name, _ in spans:
        if a <= t < b:
            if name == "gc":
                return name
            if best is None or (a, -b) > (best[0], -best[1]):
                best = (a, b, name)
    return None if best is None else best[2]


def _segments(tr: dict):
    """``(a, b, label)`` pieces of the window on which the label holds."""
    w0, w1 = tr["window"]
    cuts = {w0, w1}
    for a, b, *_ in tr["spans"] + tr["ranges"]:
        cuts.update(x for x in (a, b) if w0 < x < w1)
    cuts = sorted(cuts)
    ranges = sorted(tr["ranges"])
    starts = [a for a, _, _ in ranges]
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        harness = ranges[i][2] if i >= 0 and mid < ranges[i][1] else "host"
        span = _innermost(tr["spans"], mid)
        out.append((a, b, harness if span is None else f"{harness}/{span}"))
    return out


def summarize(tr: dict) -> dict:
    """The readings of one traced window (``window``'s dict): busy
    seconds, the idle share, the idle seconds by label, the longest idle
    gaps (seconds) with the label that holds most of each, the idle
    shares by kind (percent of the window) and the allocator's counters
    per round."""
    w0, w1 = tr["window"]
    clipped = [(max(a, w0), min(b, w1)) for a, b in tr["kernels"]
               if b > w0 and a < w1]
    busy, merged = _union(clipped)
    span_s = w1 - w0
    dev = _Busy(merged)
    segs = _segments(tr)
    by_label: Dict[str, float] = {}
    for a, b, lab in segs:
        idle = dev.idle(a, b)
        if idle > 0:
            by_label[lab] = by_label.get(lab, 0.0) + idle
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    seg_starts = [a for a, _, _ in segs]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            gaps.append((g1 - g0, g0, g1))
    gaps.sort(reverse=True)
    labelled = []
    for length, g0, g1 in gaps[:GAPS_KEPT]:
        share: Dict[str, float] = {}
        i = max(bisect.bisect_right(seg_starts, g0) - 1, 0)
        while i < len(segs) and segs[i][0] < g1:
            a, b, lab = segs[i]
            share[lab] = share.get(lab, 0.0) + min(b, g1) - max(a, g0)
            i += 1
        labelled.append([max(share, key=share.get) if share else "host",
                         length])

    def pct(pred) -> float:
        return 100.0 * sum(v for k, v in by_label.items()
                           if pred(*_split(k))) / span_s

    alloc = [ev for *_, name, ev in tr["spans"]
             if name == "round_dispatch" and "rounds" in ev]
    n_alloc = sum(ev["rounds"] for ev in alloc)
    return {
        "window_s": span_s, "busy_s": busy,
        "idle_share": 100.0 * (1.0 - busy / span_s),
        "rounds": tr["rounds"],
        "idle_by_label": dict(sorted(by_label.items(),
                                     key=lambda kv: -kv[1])),
        "idle_gaps": labelled,
        "shares": {
            "enqueue": pct(lambda h, s: s in ENQUEUE_SPANS),
            "gc": pct(lambda h, s: s == "gc"),
            "stage": pct(lambda h, s: s == "scan_stage"),
            "untraced": pct(lambda h, s: s is None and h in SOURCE_LABELS),
        },
        "alloc_frees_per_round": (
            sum(ev["num_device_free"] + ev["num_alloc_retries"]
                for ev in alloc) / n_alloc if n_alloc else None),
        "alloc": {k: sum(ev[k] for ev in alloc) for k in
                  ("num_alloc_retries", "num_device_alloc",
                   "num_device_free", "num_sync_all_streams", "rounds")}
        if alloc else None,
        "clock": tr["clock"],
    }


def _split(label: str) -> Tuple[str, Optional[str]]:
    harness, _, span = label.partition("/")
    return harness, span or None

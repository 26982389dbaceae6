"""Host-side phase spans: where a round's wall clock goes on the host (the
port's copy of ``commefficient_tpu/telemetry/spans.py``).

The ``StepProfiler`` and the ``--profile_rounds`` window say what the card
does; ``PhaseSpans`` says what the host does around it: the data wait,
the fedsim environment, the copy to the card, the round's dispatch, the
metric drain and the checkpoint writes. It records them as Chrome-trace
"complete" events and dumps ``spans_<step>.json`` into the run dir,
loadable in https://ui.perfetto.dev or ``chrome://tracing`` beside the
profiler's traces.

Fencing: host timestamps are taken for EVERY round (two ``perf_counter``
calls and a dict a span, nothing on the device), but the round-dispatch
span fences (``utils/profiling.fence``: ``torch.cuda.synchronize`` on the
card) only inside a short steady-state window, clamped like the
``StepProfiler``'s to ``MIN_WARMUP_STEPS``. Outside it the dispatch span
measures the enqueue of the round's kernels; inside it, the round's device
time too. Below telemetry level 1 no recorder is built at all.

Lanes: each event carries the recording thread as a small lane id in
``tid`` (the constructing thread is lane 0, every other thread the next
lane on first use), so the prefetch worker's ``prefetch_realize`` /
``prefetch_stage`` spans render as their own track; ``register_lane(name)``
adds a ``thread_name`` metadata event ("M", kept outside the ring) that
labels it. Worker-thread spans pass ``step=`` (the round they realize):
the shared round clock belongs to the consuming thread.

Collective exposure: spans that wait on a collective pass
``collective=True``; ``collective_exposure_ms()`` is the union of their
intervals that no other span covers. Trace correlation: ``trace_id`` (the
owning round ``r<step>``, ``telemetry/trace.py``) and ``parent``;
``span_at`` records a span from endpoints measured earlier.

The port keeps one thing the reference does not: the events of each step,
indexed as they are recorded (``events_of``), beside the ring and pruned
with it, so the per-round ``trace/*`` scalars read one round's events and
not the whole ring every round. The values are those of the ring.

Detail (``detail=True``, opt-in; the train loop's recorder keeps the
span set above): the session's round also records its phases inside
``round_dispatch`` (``ROUND_PHASES``, from the round function's ``mark``
points: host enqueue time, no fence), every collection of Python's
collector is a ``gc`` span on the lane of the thread that collects (args
``generation``, ``collected``, ``uncollectable``; the hook is installed
at construction and removed by ``close()``), and on the card each
dispatch span given ``allocator=`` carries the deltas of the caching
allocator's counters over it (``ALLOC_COUNTERS``) and the ``rounds`` it
dispatched. A detailed recorder is enabled with or without a logdir;
without one it keeps its events in memory and dumps nothing.

Clock: spans are stamped on ``perf_counter``; a ``time.time_ns()`` read
taken back to back with a ``perf_counter_ns()`` one at construction puts
them on the wall clock (``unix_ns``), the clock ``torch.profiler``'s
trace starts on (``kineto_results.trace_start_ns()``).

Format: ``{"schema_version", "kind": "spans", "displayTimeUnit",
"window", "exposed_collective_ms", "traceEvents": [{"name", "ph": "X",
"ts", "dur", "pid", "tid", "args": {"step", "fenced"[, "collective"]
[, "trace_id"][, "parent"][, detail's args]}} | {"name": "thread_name",
"ph": "M", "pid", "tid", "args": {"name"}}]}``, ts/dur in microseconds
since the recorder was built. The reference's ``scripts/check_telemetry_schema.py``
validates it.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from commefficient_tpu_torch.utils import profiling
from commefficient_tpu_torch.utils.profiling import MIN_WARMUP_STEPS

# ring bound on recorded events (~4-6 a round: the last ~1.3k rounds)
MAX_EVENTS = 8192

# a detailed recorder's spans of the round function's phases, between its
# mark points i and i + 1, children of round_dispatch
ROUND_PHASES = ("round.grads", "round.encode", "round.server",
                "round.apply")

# the caching allocator's counters a detailed dispatch span reads on the
# card (a cudaFree and an allocation retry each synchronize the device)
ALLOC_COUNTERS = ("num_alloc_retries", "num_device_alloc",
                  "num_device_free", "num_sync_all_streams")


def _alloc_counts(device) -> Dict[str, int]:
    import torch

    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return {k: int(stats.get(k, 0)) for k in ALLOC_COUNTERS}


class _SpanHandle:
    """Yielded by ``PhaseSpans.span``: lets the block arm a fence on a
    value it only produces inside (the dispatched round's metrics)."""

    __slots__ = ("fence_target",)

    def __init__(self):
        self.fence_target = None

    def fence(self, x) -> None:
        self.fence_target = x


class PhaseSpans:
    """Chrome-trace span recorder for the train loop's host phases.

    Inert when ``logdir`` is falsy, unless ``detail``. ``step(i)`` marks
    round starts (it drives the fenced window; ``num_steps=0`` fences
    none); ``span(name, fence=...)`` brackets one phase; ``span_at``
    records one from its endpoints; ``wrap_iter`` times an iterator's
    ``next()``; ``close()`` dumps ``spans_<step>.json`` (and removes a
    detailed recorder's collector hook)."""

    def __init__(self, logdir: str, start_step: int = 5, num_steps: int = 3,
                 detail: bool = False):
        self.logdir = logdir
        self.detail = bool(detail)
        self.enabled = bool(logdir) or self.detail
        self.start = max(start_step, MIN_WARMUP_STEPS)
        self.stop_at = self.start + num_steps
        self._step = -1
        self._t0 = time.perf_counter()
        # back to back: the wall clock at a perf_counter reading
        self._clock_pair = (time.perf_counter_ns(), time.time_ns())
        self.events: deque = deque(maxlen=MAX_EVENTS)
        # step -> its events still in the ring, in recording order
        self._by_step: Dict[int, deque] = {}
        self._n_collective = 0  # collective-tagged events in the ring
        self._rec_lock = threading.Lock()
        self._first_step: Optional[int] = None
        self._lanes = {threading.get_ident(): 0}
        self._lane_lock = threading.Lock()
        # lane labels live outside the ring: a long run must not evict them
        self._meta_events: List[dict] = []
        # the collector's finished spans, moved into the ring by the next
        # recording: its callback may run inside one, under _rec_lock
        self._gc_done: deque = deque()
        self._gc_t0: Optional[float] = None
        self._gc_hook = None
        if self.detail:
            self._gc_hook = self._on_gc
            gc.callbacks.append(self._gc_hook)

    def _lane(self, ident: Optional[int] = None) -> int:
        ident = threading.get_ident() if ident is None else ident
        lane = self._lanes.get(ident)
        if lane is None:
            with self._lane_lock:
                lane = self._lanes.setdefault(ident, len(self._lanes))
        return lane

    def register_lane(self, name: str) -> int:
        """Label the calling thread's track (a ``thread_name`` metadata
        event) and return its lane id; a worker thread calls it once."""
        lane = self._lane()
        if self.enabled:
            self._meta_events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": lane,
                "args": {"name": name},
            })
        return lane

    # -- round clock -------------------------------------------------------
    def step(self, step_idx: int) -> None:
        self._step = int(step_idx)
        if self.enabled and self._first_step is None:
            self._first_step = self._step

    @property
    def in_window(self) -> bool:
        """True while fenced dispatch spans are wanted."""
        return self.start <= self._step < self.stop_at

    def resume_at(self, resume_step: int) -> None:
        """Move the fenced window past a checkpoint resume (the resumed
        process pays its one-time work again; as ``StepProfiler``)."""
        floor = resume_step + MIN_WARMUP_STEPS
        if floor > self.start:
            n = self.stop_at - self.start
            self.start, self.stop_at = floor, floor + n

    # -- recording ---------------------------------------------------------
    @contextmanager
    def span(self, name: str, fence=None, step: Optional[int] = None,
             collective: bool = False, trace_id: Optional[str] = None,
             parent: Optional[str] = None, allocator=None, rounds: int = 1):
        """Record one phase. Yields a handle whose ``fence(x)`` arms a
        wait for ``x``'s device work before the span closes (``fence=``
        arms it up front); the wait runs only inside the window. ``step=``
        stamps an explicit round (worker-thread spans), ``collective=True``
        tags a collective wait, ``trace_id=`` / ``parent=`` the owning
        round's ids. ``allocator=``, a CUDA device, makes a detailed
        recorder add its allocator counters' deltas over the span and
        ``rounds`` (the rounds the span dispatched) to the args. Yields
        None when disabled."""
        if not self.enabled:
            yield None
            return
        h = _SpanHandle()
        h.fence_target = fence
        counts = (_alloc_counts(allocator) if self.detail
                  and allocator is not None and allocator.type == "cuda"
                  else None)
        t0 = time.perf_counter()
        fenced = False
        try:
            yield h
            if h.fence_target is not None and self.in_window:
                profiling.fence(h.fence_target)
                fenced = True
        finally:
            t1 = time.perf_counter()
            extra = None
            if counts is not None:
                after = _alloc_counts(allocator)
                extra = {k: after[k] - counts[k] for k in ALLOC_COUNTERS}
                extra["rounds"] = int(rounds)
            self._record(name, t0, t1, step=step, fenced=fenced,
                         collective=collective, trace_id=trace_id,
                         parent=parent, extra=extra)

    def span_at(self, name: str, t0_s: float, t1_s: float,
                step: Optional[int] = None, collective: bool = False,
                trace_id: Optional[str] = None,
                parent: Optional[str] = None) -> None:
        """Record a span from ``perf_counter`` endpoints (seconds, the
        recorder's clock) measured earlier. Nothing when disabled."""
        if not self.enabled:
            return
        self._record(name, float(t0_s), float(t1_s), step=step,
                     fenced=False, collective=collective,
                     trace_id=trace_id, parent=parent)

    def _record(self, name, t0, t1, *, step, fenced, collective,
                trace_id, parent, extra=None) -> None:
        ev = self._event(name, t0, t1, self._step if step is None else step,
                         self._lane(), fenced=fenced, collective=collective,
                         trace_id=trace_id, parent=parent, extra=extra)
        with self._rec_lock:
            self._take_gc()
            self._append(ev)

    def _event(self, name, t0, t1, step, lane, *, fenced, collective,
               trace_id, parent, extra) -> dict:
        # lint: allow[traced-purity] a host span, reached from a round only through a detailed recorder's phase mark, never set in a capture
        args = {"step": int(step), "fenced": fenced}
        if collective:
            args["collective"] = True
        if trace_id is not None:
            args["trace_id"] = str(trace_id)
            if parent is not None:
                args["parent"] = str(parent)
        if extra:
            args.update(extra)
        return {
            "name": name,
            "ph": "X",
            "ts": (t0 - self._t0) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": 0,
            "tid": lane,
            "args": args,
        }

    def _append(self, ev: dict) -> None:
        """Put ``ev`` in the ring and its step's bucket (under
        ``_rec_lock``)."""
        if len(self.events) == MAX_EVENTS:
            # the ring evicts in recording order, so the evicted event is
            # the first of its step's bucket
            old = self.events[0]
            self._n_collective -= bool(old["args"].get("collective"))
            bucket = self._by_step[old["args"]["step"]]
            bucket.popleft()
            if not bucket:
                del self._by_step[old["args"]["step"]]
        self.events.append(ev)
        self._n_collective += bool(ev["args"].get("collective"))
        self._by_step.setdefault(ev["args"]["step"], deque()).append(ev)

    # -- Python's collector (detail) ---------------------------------------
    def _on_gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` hook: no lock and no recording here (a
        collection can start inside ``_record``); the finished span waits
        in ``_gc_done`` for the next one."""
        now = time.perf_counter()
        if phase == "start":
            self._gc_t0 = now
        elif self._gc_t0 is not None:
            self._gc_done.append((self._gc_t0, now, self._step,
                                  threading.get_ident(), info))
            self._gc_t0 = None

    def _take_gc(self) -> None:
        """Move the collector's finished spans into the ring (under
        ``_rec_lock``)."""
        while self._gc_done:
            t0, t1, step, ident, info = self._gc_done.popleft()
            self._append(self._event(
                "gc", t0, t1, step, self._lane(ident), fenced=False,
                collective=False, trace_id=None, parent=None,
                extra={k: int(info.get(k, 0)) for k in
                       ("generation", "collected", "uncollectable")}))

    def flush(self) -> None:
        """Move spans still held outside the ring (the collector's) into
        it, so ``events`` holds every finished span."""
        with self._rec_lock:
            self._take_gc()

    # -- the shared clock --------------------------------------------------
    def unix_ns(self, ts_us: float) -> int:
        """Wall-clock ns (``time.time_ns()``'s clock) of a span time
        ``ts_us`` (microseconds since the recorder was built)."""
        pc_ns, wall_ns = self._clock_pair
        return wall_ns + int(round((self._t0 + ts_us * 1e-6) * 1e9)) - pc_ns

    def events_of(self, step: int) -> List[dict]:
        """The events of round ``step`` still in the ring, in recording
        order (what ``CriticalPath(self.events)`` buckets for it)."""
        with self._rec_lock:
            self._take_gc()
            return list(self._by_step.get(int(step), ()))

    def wrap_iter(self, it, name: str = "data_load"):
        """Yield from ``it``, recording each ``next()`` as one span (the
        consuming thread's wait). Transparent when disabled."""
        if not self.enabled:
            yield from it
            return
        it = iter(it)
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    # -- collective exposure -----------------------------------------------
    def collective_exposure_ms(self) -> float:
        """Wall clock (ms) inside ``collective=True`` spans that no other
        recorded span covers: the union of the collective spans minus the
        union of the others, over the ring. 0.0 when nothing is tagged,
        without walking the ring (the round reads it every round)."""
        coll, comp = [], []
        with self._rec_lock:
            self._take_gc()
            if not self._n_collective:
                return 0.0
            events = list(self.events)
        for ev in events:
            iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            if ev["args"].get("collective"):
                coll.append(iv)
            else:
                comp.append(iv)
        if not coll:
            return 0.0

        def union(ivs):
            out = []
            for a, b in sorted(ivs):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            return out

        comp_u = union(comp)
        exposed_us = 0.0
        for a, b in union(coll):
            cur = a
            for ca, cb in comp_u:
                if cb <= cur:
                    continue
                if ca >= b:
                    break
                if ca > cur:
                    exposed_us += ca - cur
                cur = max(cur, cb)
                if cur >= b:
                    break
            if cur < b:
                exposed_us += b - cur
        return exposed_us / 1000.0

    # -- dump --------------------------------------------------------------
    def dump(self) -> Optional[str]:
        """Write ``spans_<step>.json`` (step = the first recorded round);
        returns the path, or None when disabled, empty or without a
        logdir."""
        self.flush()
        if not self.enabled or not self.logdir or not self.events:
            return None
        os.makedirs(self.logdir, exist_ok=True)
        from commefficient_tpu_torch.telemetry import (
            SCHEMA_VERSION,
            jsonable_tree,
        )

        step = self._first_step if self._first_step is not None else 0
        path = os.path.join(self.logdir, f"spans_{step}.json")
        payload = {
            "schema_version": SCHEMA_VERSION,
            "kind": "spans",
            "displayTimeUnit": "ms",
            "window": [self.start, self.stop_at],
            "exposed_collective_ms": self.collective_exposure_ms(),
            "traceEvents": self._meta_events + list(self.events),
        }
        with open(path, "w") as f:
            json.dump(jsonable_tree(payload), f, allow_nan=False)
        return path

    def close(self) -> Optional[str]:
        if self._gc_hook is not None:
            gc.callbacks.remove(self._gc_hook)
            self._gc_hook = None
        return self.dump()

"""One run of a cell: set-up, the measured window, the traced readings,
then the comparison that decides ``correct``.

* Set-up builds the program (``program.py``), opens the runner's round
  source and drives it through the cell's first rounds, keeping what
  the comparison needs (each round's loss, the momentum after
  ``state_after`` rounds, the parameters after the checked rounds, all
  copied to the host), then on to ``warmup_rounds`` so that every kernel,
  plan and graph the window uses exists: the same object goes on into
  the window.
* The window opens after a device synchronize and runs the same round
  source for ``seconds`` of host time, then ends on a synchronize: every
  round dispatched in it has completed in it. A CUDA event recorded
  after each round marks its completion. Losses are drained at each
  epoch's end, as ``run_train_loop`` drains them, and once more after
  the window; a round whose loss is not finite has failed.
* A traced run (``trace``) also times the host inside the round
  source's ``next()``, records the round function's phase marks (the
  per-round path; a graph replay has none), and then traces
  ``TRACE_SECONDS`` more of the same rounds with ``torch.profiler``.
* After that the peak memory is read, the program's state freed, and
  the reference follows the first rounds (``check.py``)."""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import check, program
from benchmark.harness.spec import Cell, reader

TRACE_SECONDS = 2.0
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this


class _Clock:
    """Completion stamps: a CUDA event on the card, the host clock after
    a synchronize on the CPU."""

    def __init__(self, device: str):
        self.cuda = device == "cuda"

    def stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


class Drainer:
    """The rounds dispatched and not yet read back; read at each epoch's
    end (``run_train_loop``'s drain)."""

    def __init__(self, steps_per_epoch: int):
        self.spe = steps_per_epoch
        self.pending: List[tuple] = []
        self.losses: Dict[int, float] = {}
        self.failed = 0

    def add(self, step: int, metrics: dict) -> None:
        if self.pending and \
                self.pending[-1][0] // self.spe != step // self.spe:
            self.drain()
        self.pending.append((step, metrics["loss"]))

    def drain(self) -> None:
        for step, loss in self.pending:
            v = float(loss)
            self.losses[step] = v
            self.failed += not math.isfinite(v)
        self.pending.clear()


def _host(t: Optional[torch.Tensor]):
    return None if t is None else t.detach().to("cpu", copy=True)


def _chained(parts):
    """The round sources one after another, each closed at its end (or
    when this generator is closed)."""
    try:
        for p in parts:
            yield from p
            p.close()
    finally:
        for p in parts:
            p.close()


def setup(prog: program.Program, tr: dict):
    """Drive the round source through the first rounds; returns
    ``(rounds, drainer, first)``, ``first`` the comparison's readings.
    With ``check.split_after`` the first rounds up to it come from a round
    source of their own, so that a graph replay ends there (the scan
    engine's blocks start where its source starts) and the state after
    them can be read; the rest, the window's rounds too, come from one
    source from that round on."""
    chk = tr["check"]
    split = chk.get("split_after")
    rounds = (_chained([prog.rounds(0, split), prog.rounds(split)])
              if split else prog.rounds())
    drainer = Drainer(prog.sampler.steps_per_epoch())
    first = {}
    for _ in range(tr["warmup_rounds"]):
        s, _, metrics, _, _ = next(rounds)
        drainer.add(s, metrics)
        st = prog.session.state
        if st.step == chk["state_after"] and "state" not in first:
            first["state"] = _host(st.momentum)
        if st.step == chk["rounds"] and "params" not in first:
            first["params"] = _host(st.params_vec)
    drainer.drain()
    if set(first) != {"state", "params"}:
        raise RuntimeError("set-up never saw the state after the checked "
                           f"rounds {chk}: blocks of the round source "
                           "end elsewhere")
    first["losses"] = [drainer.losses[s] for s in range(chk["rounds"])]
    return rounds, drainer, first


def _marked(session, marks: list):
    """Wrap the session's round function so each round records its five
    phase marks (``build_round_fn``'s ``mark``)."""
    inner = session.round_fn

    def round_fn(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        marks.append(ev)
        return inner(*args, mark=lambda i: ev[i].record(), **kw)

    session.round_fn = round_fn
    return inner


def window(prog, rounds, drainer, seconds: float, clock: _Clock,
           trace: bool) -> dict:
    """The measured window; returns its readings."""
    per_round = prog.cfg.scan_rounds <= 1
    marks: list = []
    inner = _marked(prog.session, marks) if trace and per_round and \
        clock.cuda else None
    clock.sync()
    t0 = time.perf_counter()
    start = clock.stamp()
    stamps, host_s = [], []
    failed0 = drainer.failed
    while True:
        a = time.perf_counter()
        s, _, metrics, _, _ = next(rounds)
        b = time.perf_counter()
        stamps.append(clock.stamp())
        host_s.append(b - a)
        drainer.add(s, metrics)
        if b - t0 >= seconds:
            break
    clock.sync()
    t1 = time.perf_counter()
    drainer.drain()
    if inner is not None:
        prog.session.round_fn = inner
    gaps = [clock.ms(start, stamps[0])] + [
        clock.ms(x, y) for x, y in zip(stamps, stamps[1:])]
    phases = [[clock.ms(ev[i], ev[i + 1]) for i in range(4)]
              for ev in marks]
    return {"t0": t0, "seconds": t1 - t0, "rounds": len(stamps),
            "gaps_ms": gaps, "host_s": host_s, "phases_ms": phases,
            "failed": drainer.failed - failed0}


def _union(intervals):
    total, end = 0.0, -math.inf
    merged = []
    for a, b in sorted(intervals):
        if a > end:
            merged.append([a, b])
        elif b > end:
            merged[-1][1] = b
        end = max(end, b)
    for a, b in merged:
        total += b - a
    return total, merged


def profile(prog, rounds, drainer, seconds: float) -> dict:
    """``seconds`` more rounds under ``torch.profiler``, tracing the
    device only (recording every host op would slow the host-bound
    per-round path and read as idle time): the device's busy seconds (the
    union of its kernels' intervals), the traced window's length, the
    kernels' time by name and the longest idle gaps, each labelled by what
    the benchmark's host loop was doing then (``dispatch``: inside the
    round source's ``next()``, ``epoch_staging`` where that call staged a
    new epoch of a scan engine, ``drain``: reading losses back). The host
    ranges are put on the trace's clock by a marker kernel launched on an
    idle device at a known host time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    ranges = []
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1)  # the marker
        torch.cuda.synchronize()
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
        torch.cuda.synchronize()
        tb = time.perf_counter()
    kernels, by_name, mark = [], {}, None
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.time_range
        if mark is None and "spin_kernel" in e.name:
            mark = t.start / 1e6
            continue
        kernels.append((t.start / 1e6, t.end / 1e6))
        by_name[e.name] = by_name.get(e.name, 0.0) + t.elapsed_us() / 1e6
    busy, merged = _union(k for k in kernels if mark is None or k[0] > mark)
    shift = (mark - t_mark) if mark is not None else None
    gaps = []
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        label = "host"
        if shift is not None:
            mid = 0.5 * (end + nxt) - shift
            label = next((lab for a, b, lab in ranges if a <= mid <= b),
                         "host")
        gaps.append([label, nxt - end])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": tb - ta,
            "device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
            "idle_gaps": gaps[:10]}


class Context:
    """What a metric's reader reads: the cell, the program, the set-up
    time, the window, the trace and the peak memory."""

    def __init__(self, cell: Cell, prog, setup_s: float, win: dict,
                 prof: Optional[dict], peak_bytes: int):
        self.cell, self.program = cell, prog
        self.setup_s, self.window, self.profile = setup_s, win, prof
        self.peak_bytes = peak_bytes


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, tamper=None) -> dict:
    """One run; returns the result's fields. ``tamper(session)``, when
    given, breaks the timed path before set-up drives it (the tests'
    faults)."""
    tr = cell.traffic
    clock = _Clock(device)
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats()
    prog = program.build(cell.config, tr, seed, device)
    if tamper is not None:
        tamper(prog.session)
    rounds, drainer, first = setup(prog, tr)
    collections = [g["collections"] for g in gc.get_stats()]
    win = window(prog, rounds, drainer, seconds, clock, trace)
    win["gc_collections"] = [g["collections"] - c for g, c in
                             zip(gc.get_stats(), collections)]
    setup_s = win["t0"] - t_start
    prof = (profile(prog, rounds, drainer, TRACE_SECONDS)
            if trace and clock.cuda else None)
    peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    ctx = Context(cell, prog, setup_s, win, prof, peak)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    rounds.close()
    data, client_indices = prog.data, prog.client_indices
    del prog, ctx, rounds, drainer
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    ref = check.follow(cell.config, tr, seed, data, client_indices, device)
    values = check.numbers(cell.config, tr, seed, first, ref)
    gaps = sorted(win["gaps_ms"])
    print("window rounds", win["rounds"], "seconds", win["seconds"],
          "gap_ms min/median/p95/max", gaps[0], statistics.median(gaps),
          gaps[math.ceil(0.95 * len(gaps)) - 1], gaps[-1],
          "gc collections by generation", win["gc_collections"],
          file=sys.stderr)
    return {"correct": check.verdict(values, tr["limits"]) and
            win["failed"] == 0,
            "attempted": win["rounds"], "failed": win["failed"],
            "metrics": metrics, "peak_bytes": peak, "profile": prof,
            "checks": {k: {"value": values[k], "limit": tr["limits"][k]}
                       for k in check.NUMBERS}}

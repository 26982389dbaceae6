"""AsyncFederation — the buffered-asynchronous round engine (the port's copy
of ``commefficient_tpu/asyncfed/engine.py``).

One engine step is one SERVER UPDATE (the runner's ``(step, lr, metrics)``
unit stays a round, so its drains, checkpoints and recoveries are
untouched). For update ``u`` the engine:

1. launches the cohorts ``AsyncSchedule.updates[u].launches_before``
   names, each realized in cohort order by a ``CohortScheduler``
   (pipeline/cohorts.py) and run through the active rung's ``launch_fn``
   against the CURRENT params (server version ``u``);
2. assembles the update's K consumed ``(cohort, slot)`` rows (canonical
   order, see asyncfed/schedule.py) into a fixed ``[W, ...]`` assembly,
   padded with zero-weight repeats of slot 0;
3. weights slot ``i`` by ``live_i * (1 + staleness_i)^(-alpha)`` (f32, on
   the host), calls the controller's decision point with the update's
   ``fedsim/*`` and ``async/*`` scalars, and applies through the active
   rung's ``apply_fn``.

Telemetry: the update's ``fedsim/*`` scalars are the consumed slots'
mixture of their cohorts' stats (at K = W, C = 1 the cohort's own, so the
ledger bills what the synchronous run bills), plus five ``async/*``
scalars (staleness mean and max, buffer fill, cohorts in flight,
effective participation), which also feed the control plane. With a span
recorder: ``async_launch`` on the cohort's trace id (its parent the round
it launched against), ``async_apply`` (``async_apply_dispatch`` under
double buffering) and ``async_apply_drain`` on the round's,
``async_buffer_residency`` from a cohort's launch to its retirement
(``span_at``), and the markers ``async_rung_switch:*``,
``async_retune:*`` and ``async_recovery_restart:*``.

Double buffering (``cfg.async_double_buffer``): the apply's host fence is
parked and taken only after the next update's launches are queued. The
device order of the programs is the same on the one CUDA stream, so the
values are bit-equal to the run without it.

Ladder: a rung switch at the decision point changes which pair later
dispatches use; rows launched under the old rung are dense ``[D]``
transmits in every mode and are encoded under the new rung's apply. A
(K, C) retune (``staleness_aware``) is parked and applied at the top of
the next update: the schedule is rebuilt and the window cold-restarted.

Resilience: the in-flight window (pending outputs, consumed counts,
cohort horizon, the (K, C) it was captured under) rides the vault
snapshot (``snapshot_extra`` / ``restore_extra``, host copies), so a
rollback replays bit for bit, rows launched before the rollback point
included. A checkpoint resume has no window: it cold-restarts, the
schedule's pending cohorts relaunched against the RESUMED params at their
scheduled versions (their lr and DP keys), deterministic from there on
but not the unbroken run.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from commefficient_tpu_torch.asyncfed.schedule import AsyncSchedule, UpdateSpec
from commefficient_tpu_torch.pipeline.cohorts import CohortScheduler
from commefficient_tpu_torch.telemetry.trace import (
    cohort_trace_id,
    round_trace_id,
)


def _nbytes(out) -> int:
    """Bytes of one launch's outputs (tensors, None, an aux dict)."""
    rows, vel, err, loss, aux = out
    return sum(t.numel() * t.element_size()
               for t in (rows, vel, err, loss, *aux.values())
               if t is not None)


def _to(out, device):
    """A launch's outputs copied to ``device`` (a host snapshot's, and its
    way back)."""
    rows, vel, err, loss, aux = out

    def move(t):
        return None if t is None else t.detach().to(device, copy=True)

    return (move(rows), move(vel), move(err), move(loss),
            {k: move(v) for k, v in aux.items()})


class AsyncFederation:
    """The runner's round source when ``cfg.async_buffer > 0``, with
    ``PipelinedRounds``' protocol: ``start(resume_step)``,
    ``epoch_rounds(epoch, start_step, stop_step, before_dispatch=None)``
    yielding ``(step, lr, metrics, wait_ms, t_dispatch)``,
    ``restart(step)``, ``close()``, ``stats()``; and the vault's riders
    ``snapshot_extra`` / ``restore_extra``. ``num_rounds`` is the run's
    length (the schedule's; ``stop_step`` may end a run earlier)."""

    def __init__(self, cfg, session, sampler, lr_fn, num_rounds: int,
                 steps_per_epoch: Optional[int] = None):
        self.cfg = cfg
        self.session = session
        self.sampler = sampler
        self.lr_fn = lr_fn
        self.num_rounds = int(num_rounds)
        self.steps_per_epoch = int(steps_per_epoch if steps_per_epoch
                                   is not None else sampler.steps_per_epoch())
        self.W = int(cfg.num_workers)
        self._alpha = float(cfg.staleness_exponent)
        # the engine's (K, C): the config's, or under an ADAPTS_ASYNC
        # policy the controller's (its blob restores a retuned pair before
        # start, so a resume runs the retuned schedule)
        self._k = int(cfg.async_buffer)
        self._c = int(cfg.async_concurrency)
        ctl = session.controller
        adapts = ctl is not None and ctl.policy.ADAPTS_ASYNC
        if adapts:
            self._k, self._c = int(ctl.async_k), int(ctl.async_c)
        self.schedule = self._build_schedule()
        self._scheduler: Optional[CohortScheduler] = None
        # the in-flight window: cohort -> its launch (device outputs, host
        # ids, live mask, stats, version, rung, launch time)
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._consumed: Dict[int, int] = {}  # cohort -> slots consumed
        self._next_cohort = 0
        # the replay fence in cohorts: a cohort below it was realized in
        # this process and realizes its environment with replay=True
        self._cohort_horizon = 0
        self._restored = None
        self.restarts = 0
        self.quiesces = 0
        self.retunes_applied = 0
        self._updates_run = 0
        self._cohorts_launched = 0
        self._host_stall_ms = 0.0
        self._prefetch_host_ms = 0.0
        self._window_bytes_max = 0
        self._window_cohorts_max = 0
        self._snapshot_ms: Optional[float] = None
        self._snapshot_bytes = 0
        self._double_buffer = bool(cfg.async_double_buffer)
        self._deferred = None  # (loss, step) of a parked apply fence
        self._retune_pending = None  # (K, C) parked by a decision point
        if ctl is not None:
            ctl.add_switch_listener(self._on_rung_switch)
            if adapts:
                ctl.add_retune_listener(self._on_retune)

    # -- lifecycle ------------------------------------------------------------
    def start(self, resume_step: int = 0) -> "AsyncFederation":
        if self._scheduler is None:
            self._init_window(int(resume_step), None)
        return self

    def restart(self, step: int) -> None:
        """A rollback's restart at update ``step``: the window the vault
        snapshot carried (``restore_extra`` first), else a cold
        rebuild."""
        self._drain_deferred()
        self._close_scheduler()
        blob, self._restored = self._restored, None
        self._pending, self._consumed = {}, {}
        if blob is not None:
            # the snapshot's (K, C) wins: its window was captured under
            # that schedule, and the controller's restored blob names the
            # same pair, so a parked retune is stale
            k, c = int(blob.get("k", self._k)), int(blob.get("c", self._c))
            if (k, c) != (self._k, self._c):
                self._k, self._c = k, c
                self.schedule = self._build_schedule()
            self._retune_pending = None
        self._init_window(int(step), blob)
        self.restarts += 1
        self._marker(f"async_recovery_restart:round{int(step)}")

    def close(self) -> None:
        """Fence a parked apply and stop the cohort worker (the runner
        calls this on every exit)."""
        self._drain_deferred()
        self._close_scheduler()

    def _close_scheduler(self) -> None:
        if self._scheduler is not None:
            self._scheduler.close()
            self._scheduler = None

    def _build_schedule(self) -> AsyncSchedule:
        """The arrival and consumption script of the current (K, C), for
        the whole run (rebuilt whole on a retune: the same seed, so the
        arrival process is the same deterministic object)."""
        return AsyncSchedule(
            seed=self.cfg.seed, num_workers=self.W, buffer_k=self._k,
            concurrency=self._c, arrival_rate=self.cfg.arrival_rate,
            num_updates=self.num_rounds)

    def _build_scheduler(self, start_cohort: int) -> CohortScheduler:
        return CohortScheduler(
            session=self.session, sampler=self.sampler, lr_fn=self.lr_fn,
            launch_versions=self.schedule.launch_version,
            start_cohort=start_cohort, stop_cohort=self.schedule.num_cohorts,
            depth=max(1, self._c), spans=self.session.spans,
            replay_until=self._cohort_horizon).start()

    def _init_window(self, step: int, blob) -> None:
        """The in-flight window at update ``step``: the vault blob's when
        it was captured there (bit-for-bit replay), else the launched and
        consumed sets derived from the schedule, the cohorts with slots
        left relaunched against the current params."""
        if blob is not None and int(blob.get("update", -1)) == step:
            dev = self.session.device
            self._pending = {int(c): {**p, "out": _to(p["out"], dev)}
                             for c, p in blob["pending"].items()}
            self._consumed = {int(c): int(n)
                              for c, n in blob["consumed"].items()}
            self._next_cohort = int(blob["next_cohort"])
            self._cohort_horizon = max(self._cohort_horizon,
                                       int(blob["cohort_horizon"]))
            self._scheduler = self._build_scheduler(self._next_cohort)
            return
        consumed: Dict[int, int] = {}
        for u in range(step):
            for c, _s in self.schedule.updates[u].slots:
                consumed[c] = consumed.get(c, 0) + 1
        launched = self.schedule.launched_before(step)
        need = {c for c in range(launched) if consumed.get(c, 0) < self.W}
        self._consumed = consumed
        self._next_cohort = launched
        start_c = min(need) if need else launched
        self._scheduler = self._build_scheduler(start_c)
        # get() is in order: walk the window, relaunching the cohorts
        # with slots left
        for c in range(start_c, launched):
            work = self._scheduler.get(c)
            if c in need:
                self._launch_work(c, work)

    # -- spans ----------------------------------------------------------------
    def _span(self, name: str, **kw):
        spans = self.session.spans
        return (spans.span(name, **kw) if spans is not None
                else contextlib.nullcontext())

    def _marker(self, name: str) -> None:
        with self._span(name):
            pass

    def _drain_deferred(self) -> None:
        """Fence the previous update's parked apply (double buffering):
        after the next update's launches, and on every path that leaves
        the loop (restart, close, snapshot), so the window never rides an
        unfenced apply into the vault. The span carries the parked
        update's step and trace id."""
        if self._deferred is None:
            return
        (loss, step), self._deferred = self._deferred, None
        with self._span("async_apply_drain", step=step,
                        collective=self.session.group.size > 1,
                        trace_id=round_trace_id(step)) as sp:
            if sp is not None:
                sp.fence(loss)

    # -- launch ---------------------------------------------------------------
    def _launch_work(self, c: int, work) -> None:
        """Run cohort ``c``'s launch against the current params and park
        its outputs in the window."""
        sess = self.session
        host_ids = np.asarray(work.host_ids, np.int64)
        # the prefetcher composed the blacklist of its time; a recovery's
        # may have grown since
        env = sess.blacklist_env(work.env, host_ids)
        ids, batch = sess.device_inputs(work.client_ids, work.batch,
                                        work.ready)
        launch_fn, _ = sess.async_round_fns()
        version = int(self.schedule.launch_version[c])
        with self._span("async_launch", trace_id=cohort_trace_id(c),
                        parent=round_trace_id(version)):
            out = launch_fn(sess.state, ids, batch, version,
                            float(np.float32(work.lr)), env=env)
        self._pending[c] = {
            "out": out, "cids": host_ids,
            "live": (None if env is None
                     else np.asarray(env.live, np.float32)),
            "stats": {} if env is None else dict(env.stats),
            "version": version, "rung": int(sess.active_rung),
            # for the residency span at retirement (a window restored
            # from the vault has none: its launch time did not survive)
            "t_launch": time.perf_counter()}
        self._cohorts_launched += 1
        self._prefetch_host_ms += float(work.host_ms)
        self._cohort_horizon = max(self._cohort_horizon, c + 1)

    # -- the (K, C) retune ----------------------------------------------------
    def _on_retune(self, step: int, k: int, c: int) -> None:
        """The controller's retune listener (also called by a blob load:
        the pair this engine already runs changes nothing)."""
        if (int(k), int(c)) != (self._k, self._c):
            self._retune_pending = (int(k), int(c))

    def _apply_retune(self, step: int) -> None:
        """Rebuild the schedule and cold-restart the window under the
        retuned (K, C), as ``restart`` does without a blob."""
        (self._k, self._c), self._retune_pending = self._retune_pending, None
        self._drain_deferred()
        self._close_scheduler()
        self.schedule = self._build_schedule()
        self._pending, self._consumed = {}, {}
        self._init_window(int(step), None)
        self.retunes_applied += 1
        self._marker(f"async_retune:round{step}:k{self._k}c{self._c}")

    def _on_rung_switch(self, step: int, old: int, new: int) -> None:
        """The controller's switch listener: the window's rows are dense
        transmits whatever the rung, so nothing is relaunched."""
        self.quiesces += 1
        self._marker(f"async_rung_switch:round{step}")

    # -- the update loop ------------------------------------------------------
    def epoch_rounds(self, epoch: int, start_step: int, stop_step: int,
                     before_dispatch=None):
        """Yield ``(step, lr, metrics, wait_ms, t_dispatch)`` for the
        updates of epoch ``epoch`` in ``[start_step, stop_step)``:
        ``wait_ms`` the wait for the update's staged cohorts,
        ``t_dispatch`` the ``perf_counter`` time the update began."""
        if self._scheduler is None:
            raise RuntimeError("AsyncFederation.epoch_rounds before start()")
        spe = self.steps_per_epoch
        for step in range(max(epoch * spe, start_step),
                          min((epoch + 1) * spe, stop_step)):
            t_disp = time.perf_counter()
            # a retune parked by the previous update's decision point
            if self._retune_pending is not None:
                self._apply_retune(step)
            if before_dispatch is not None:
                before_dispatch(step)
            spans = self.session.spans
            if spans is not None:
                spans.step(step)
            arm = self.session.audit_arm
            arm = arm if arm is not None and arm.armed else None
            with arm.measure(step) if arm else contextlib.nullcontext():
                metrics, lr, stall = self._update(step)
            if arm:
                arm.finish()  # the report, outside the update's spans
            self._updates_run += 1
            yield step, lr, metrics, stall, t_disp

    def _update(self, step: int):
        spec = self.schedule.updates[step]
        stall = 0.0
        for c in spec.launches_before:
            t0 = time.perf_counter()
            work = self._scheduler.get(c)  # re-raises a worker fault
            stall += (time.perf_counter() - t0) * 1e3
            self._launch_work(c, work)
            self._next_cohort = c + 1
        self._host_stall_ms += stall
        window = sum(_nbytes(p["out"]) for p in self._pending.values())
        if window > self._window_bytes_max:
            self._window_bytes_max = window
        self._window_cohorts_max = max(self._window_cohorts_max,
                                       len(self._pending))
        # double buffering: the previous apply is fenced here, after this
        # update's launches are queued
        self._drain_deferred()
        lr = float(self.lr_fn(step))
        return self._apply_update(step, spec, lr), lr, stall

    def _slot_weights(self, spec: UpdateSpec) -> np.ndarray:
        """The slots' weights in f32: the live mask times the staleness
        discount (FedBuff), 0 on the padding."""
        w = np.zeros(self.W, np.float32)
        for i, (c, s) in enumerate(spec.slots):
            lv = self._pending[c]["live"]
            base = 1.0 if lv is None else float(lv[s])
            w[i] = base * (1.0 + spec.staleness[i]) ** (-self._alpha)
        return w

    def _update_stats(self, spec: UpdateSpec, wsum: float) -> Dict[str, float]:
        """The update's host scalars: the consumed slots' mixture of their
        cohorts' ``fedsim/*`` (at K = W, C = 1 the cohort's own) and the
        ``async/*`` scalars."""
        W = self.W
        out: Dict[str, float] = {}
        if self.session.fedsim_env is not None:
            counts: Dict[int, int] = {}
            n_live = 0.0
            for c, s in spec.slots:
                counts[c] = counts.get(c, 0) + 1
                lv = self._pending[c]["live"]
                n_live += 1.0 if lv is None else float(lv[s])

            def mix(key: str) -> float:
                return sum((n / W) * float(
                    self._pending[c]["stats"].get(key, 0.0))
                    for c, n in counts.items())

            out = {
                "fedsim/participation_rate": n_live / W,
                "fedsim/dropped": mix("fedsim/dropped"),
                "fedsim/straggler_excluded": mix("fedsim/straggler_excluded"),
                "fedsim/all_dropped": float(wsum == 0.0),
                "fedsim/preempt": max(float(self._pending[c]["stats"].get(
                    "fedsim/preempt", 0.0)) for c in counts),
            }
        st = spec.staleness
        out.update({
            "async/staleness_mean": float(sum(st)) / max(len(st), 1),
            "async/staleness_max": float(max(st)) if st else 0.0,
            "async/buffer_fill": float(spec.buffer_fill_after),
            "async/concurrent_cohorts": float(spec.concurrent_after),
            "async/effective_participation": float(wsum),
        })
        return out

    def _apply_update(self, step: int, spec: UpdateSpec, lr: float):
        sess = self.session
        W, K = self.W, len(spec.slots)
        # the fixed [W] assembly: the padding repeats slot 0 at weight 0
        # (the where-gate blocks even a NaN payload)
        sel = list(spec.slots) + [spec.slots[0]] * (W - K)
        outs = [self._pending[c]["out"] for c, _s in sel]

        def stack(i):
            if outs[0][i] is None:
                return None
            return torch.stack([o[i][s] for o, (_c, s) in zip(outs, sel)])

        aux_rows = {k: torch.stack([o[4][k][s] for o, (_c, s)
                                    in zip(outs, sel)])
                    for k in outs[0][4]}
        cids = np.asarray([self._pending[c]["cids"][s] for c, s in sel],
                          np.int64)
        w = self._slot_weights(spec)
        wsum = float(np.float32(w.sum(dtype=np.float32)))
        fs_stats = self._update_stats(spec, wsum)
        # the decision point, before the dispatch: a switch makes this
        # update apply under the new rung's pair
        sess.control_round_start(step, fs_stats)
        _, apply_fn = sess.async_round_fns()
        name = ("async_apply_dispatch" if self._double_buffer
                else "async_apply")
        collective = sess.group.size > 1
        with self._span(name, collective=collective and not
                        self._double_buffer,
                        trace_id=round_trace_id(step)) as sp:
            sess.state, metrics = apply_fn(
                sess.state, stack(0), stack(1), stack(2), stack(3), aux_rows,
                cids, w, wsum, float(np.float32(lr)),
                draw=sess.server_draw(sess.state.step))
            if sp is not None:
                if self._double_buffer:
                    self._deferred = (metrics["loss"], step)
                else:
                    sp.fence(metrics["loss"])
        sess.mark_dispatched(step)
        for c, _s in spec.slots:
            self._consumed[c] = self._consumed.get(c, 0) + 1
        for c in sorted({cc for cc, _ in spec.slots}):
            if self._consumed.get(c, 0) >= W:
                p = self._pending.pop(c, None)  # fully consumed: retired
                spans = sess.spans
                if p is not None and spans is not None and "t_launch" in p:
                    spans.span_at("async_buffer_residency", p["t_launch"],
                                  time.perf_counter(), step=step,
                                  trace_id=cohort_trace_id(c),
                                  parent=round_trace_id(p["version"]))
        return sess.host_round_stats(metrics, fs_stats)

    # -- the vault's riders ---------------------------------------------------
    def snapshot_extra(self) -> Dict[str, Any]:
        """A host copy of the in-flight window for the vault's snapshot:
        restoring it replays the rolled-back updates bit for bit (the rows
        are not launched again: the blacklist may have grown since, and
        the rows must be the ones the first pass saw)."""
        self._drain_deferred()
        t0 = time.perf_counter()
        pending = {int(c): {"out": _to(p["out"], "cpu"),
                            "cids": np.array(p["cids"], copy=True),
                            "live": (None if p["live"] is None
                                     else np.array(p["live"], copy=True)),
                            "stats": dict(p["stats"]),
                            "version": int(p["version"]),
                            "rung": int(p["rung"])}
                   for c, p in self._pending.items()}
        self._snapshot_ms = (time.perf_counter() - t0) * 1e3
        self._snapshot_bytes = sum(_nbytes(p["out"])
                                   for p in pending.values())
        return {"update": int(self.session.state.step),
                "next_cohort": int(self._next_cohort),
                "cohort_horizon": int(self._cohort_horizon),
                "k": int(self._k), "c": int(self._c),
                "consumed": {int(c): int(n)
                             for c, n in self._consumed.items()},
                "pending": pending}

    def restore_extra(self, blob) -> None:
        """Keep a vault snapshot's window for the next ``restart``."""
        self._restored = blob

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Counts and means over the run: updates, cohorts launched, the
        host's wait for staged cohorts (ms, summed), the prefetch worker's
        ms a cohort, restarts, rung switches seen, retunes applied, the
        largest window (bytes and cohorts, after an update's launches) and
        the last snapshot's copy (ms and bytes)."""
        n = max(self._cohorts_launched, 1)
        return {"updates": self._updates_run,
                "cohorts_launched": self._cohorts_launched,
                "host_stall_ms": self._host_stall_ms,
                "prefetch_host_ms": self._prefetch_host_ms / n,
                "restarts": self.restarts,
                "quiesces": self.quiesces,
                "retunes_applied": self.retunes_applied,
                "window_bytes_max": self._window_bytes_max,
                "window_cohorts_max": self._window_cohorts_max,
                "snapshot_ms": self._snapshot_ms,
                "snapshot_bytes": self._snapshot_bytes}

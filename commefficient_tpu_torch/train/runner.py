"""The train-loop runner (the reference's ``train/runner.py``, minimal).

Epoch loop with the piecewise-linear lr, one round per step, an
end-of-epoch eval and a console row. The round source is chosen here, the
one place ``cfg.pipeline_depth`` is read:

* depth 0 (``_sync_epoch_rounds``, the reference's): the sampler's epoch
  (``sampler.epoch``, or ``epoch_indices`` with the training set on the
  device) runs through ``data/sampler.py::prefetch``, a background thread
  two rounds ahead, so the draw and the batch assembly (the native gather,
  GIL released) overlap the rounds the main thread launches; each round's
  arrays are copied to the device at dispatch;
* depth > 0: ``pipeline.PipelinedRounds``, whose worker realizes and
  stages rounds (pinned buffers, a side stream) ``pipeline_depth`` ahead;
* ``async_buffer > 0``: ``asyncfed.AsyncFederation``, each step one server
  update consuming K of the C in-flight cohorts' contributions (built
  after the restore, as the pipelined engine is; its window rides the
  vault's snapshots under ``extras["asyncfed"]``).

The first two yield the same rounds in the same order, bit for bit; the
third is the synchronous round bit for bit at K = W, C = 1, exponent 0. No metric is
read back a round: each round's ``(step, lr, metrics)`` goes to a
``pending`` list, drained (the losses read back and accumulated, in step
order) at each epoch's end and before each checkpoint save (``will_save``,
then the drain, then the save). Checkpoint/resume (``utils/checkpoint.py``):
with ``cfg.resume`` the newest checkpoint is restored and the loop
fast-forwards to its round, skipping ``s < start`` within the epoch (the
sampler, the lr schedule and the fedsim environment are pure functions of
the round, so the resumed run is the unbroken one); a save every
``checkpoint_every`` rounds and a forced one at the end. The chaos plan's
rounds are checked against the run length at entry.
``cfg.max_rounds > 0`` stops the run once ``max_rounds`` rounds are done
and evaluates once.

Telemetry (the reference's riders): rank 0's ``MetricsWriter`` (the entry
points make it) gets, at each drain (``utils/logging.drain_round_metrics``:
one packed copy to the host), ``train/loss``, ``lr``, every namespaced key
of the round (``diag/*``, ``fedsim/*``) and, at ``telemetry_level >= 1``,
the ``CommLedger``'s ``comm/*``; each epoch's evaluation goes in as
``val/*``. At level >= 1 every rank keeps a ``FlightRecorder`` (only rank
0's writes) that raises ``DivergenceError`` at the first drained round
whose loss or ``diag/nonfinite`` is non-finite; the error is not caught.
Any other crash first drains the rounds dispatched so far, then dumps
the ring; ``comm_ledger.json`` is written on every exit. ``cfg.profile_dir``
arms a ``StepProfiler`` window, stepped as each round is dispatched and
moved past a resume; ``cfg.profile_rounds`` stacks a ``ProfilerWindow``
beside it (``telemetry/trace.py``), its traces in ``profile_dir`` or
``<run dir>/profile_rounds``.

Host observability (rank 0, level >= 1 with a writer;
``telemetry.build_perf_observability``): a ``PhaseSpans`` on the session
records the session's round spans, the prefetch lane at depth > 0, and
here the wait on the prefetch queue (``data_load``, depth 0), the drains
(``metric_drain``, under the newest pending round's trace id) and the
saves (``checkpoint``); the first dispatched round is audited into
``perf_report.json``. On every exit, crashes included, the spans are
detached and dumped (``spans_<step>.json``), then ``run_report.json`` is
written (``cfg.run_report``), then the ledger.

The control plane (``control/``, ``cfg.control_enabled``): the
``BudgetController`` is built before the telemetry riders (the ledger
bills per rung, the flight recorder carries its block) and before any
restore (the checkpoint's blob restores into it), prewarmed (every rung's
kernel plans built) and described; every drain feeds it the drained
rounds. A ``BudgetExhaustedError`` raised before a round's dispatch takes
the crash path: the epoch's rounds dispatched so far are drained first
(the ledger and the ring see them), the ring is dumped, and the error is
raised.

The resilience layer (``resilience/``, built after the riders and before
the restore; None unless ``--recover_policy`` or a preemption source is
set): the vault's baseline snapshot is taken at the start round, and at
each ``snapshot_every`` boundary the loop drains, then snapshots (the
epoch's accumulator and round count ride along). A ``DivergenceError``
from any drain goes to the rider first: a recovery restores the newest
snapshot at or before the first bad round, drops the history rows of the
rolled-back rounds (the healed run's history has one row a round, as the
unbroken run's), re-seeds a mid-epoch accumulator, drops the checkpoints
above the rollback round (and, after a forking policy, saves it again),
restarts the round source there and re-enters the epoch loop; an epoch
whose end block already ran runs it again only after a forking policy.
Only a divergence it cannot recover from takes the crash path. A
preemption request (``--preempt_signals`` or chaos ``preempt@R``) is
honored at the round boundary: drain, force-save, write
``resilience/preempt_requested``, raise ``PreemptShutdown``; the entry
points turn it into exit code 75. A hosted client store's streamer is
closed on every exit (its fence, then its writeback worker joined).
"""

from __future__ import annotations

import copy
import os
import time
from contextlib import closing, nullcontext
from functools import partial

from commefficient_tpu_torch.control import build_controller
from commefficient_tpu_torch.data.sampler import prefetch
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.resilience import (
    PreemptShutdown,
    build_resilience,
)
from commefficient_tpu_torch.telemetry import (
    DivergenceError,
    FlightRecorder,
    ProfilerStack,
    ProfilerWindow,
    build_perf_observability,
    build_telemetry_riders,
    record_crash,
    round_trace_id,
    write_run_report,
)
from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer
from commefficient_tpu_torch.utils.logging import (
    TableLogger,
    Timer,
    drain_round_metrics,
)
from commefficient_tpu_torch.utils.profiling import StepProfiler, fence
from commefficient_tpu_torch.utils.schedule import piecewise_linear_lr


class WorkloadHooks:
    """What a workload entry plugs into the runner."""

    def new_accumulator(self):
        raise NotImplementedError

    def accumulate(self, acc, loss, metrics) -> None:
        raise NotImplementedError

    def evaluate(self) -> dict:
        raise NotImplementedError

    def write_val(self, writer, val: dict, step: int) -> None:
        """Write the epoch's ``val/*`` scalars."""
        raise NotImplementedError

    def epoch_row(self, *, epoch, lr, acc, val, train_time, val_time,
                  rounds) -> dict:
        raise NotImplementedError

    def on_epoch_end(self, epoch: int, val: dict) -> None:
        """Called on rank 0 after each epoch's evaluation (GPT-2: a sample
        generation)."""


def _sync_epoch_rounds(cfg, session, sampler, lr_fn, epoch: int,
                       start: int, stop: int, before_dispatch=None):
    """The synchronous round source (``pipeline_depth 0``): epoch
    ``epoch``'s rounds in ``[start, stop)`` through the sampler's prefetch
    thread, each dispatched as it arrives (``before_dispatch(step)`` just
    before, when given). Yields ``(step, lr, metrics, wait_ms,
    t_dispatch)``: ``wait_ms`` the wait on the prefetch queue,
    ``t_dispatch`` the ``perf_counter`` time the round was dispatched.
    With the session's span recorder attached, each wait is a
    ``data_load`` span on the round clock as it stands (the previous
    round's, as the reference's ``wrap_iter`` stamps it)."""
    spe = sampler.steps_per_epoch()
    spans = session.spans
    on_device = session.data_path == "device"
    rounds = prefetch(sampler.epoch_indices(epoch) if on_device
                      else sampler.epoch(epoch))
    try:
        s = epoch * spe
        while s < min(stop, (epoch + 1) * spe):
            t0 = time.perf_counter()
            item = next(rounds)
            t1 = time.perf_counter()
            wait_ms = 1e3 * (t1 - t0)
            if spans is not None:
                spans.span_at("data_load", t0, t1)
            if s >= start:  # fast-forward within the resumed epoch
                lr = float(lr_fn(s))
                if before_dispatch is not None:
                    before_dispatch(s)
                t_disp = time.perf_counter()
                if on_device:  # (client ids, [W, B] indices, the plan)
                    metrics = session.train_round_indices(*item, lr)
                else:  # (client ids, the host batch)
                    client_ids, batch = item
                    metrics = session.train_round(
                        client_ids, microbatched(cfg, batch), lr)
                yield s, lr, metrics, wait_ms, t_disp
            s += 1
    finally:
        rounds.close()  # stops and joins the producer


def round_source(cfg, session, sampler, lr_fn, start: int, stop: int):
    """Rounds ``[start, stop)`` as ``run_train_loop`` runs them at
    ``cfg.pipeline_depth`` (depth 0: ``_sync_epoch_rounds``, epoch by
    epoch; depth > 0: a ``PipelinedRounds`` engine over the range, closed
    at the end), with no metric read back: what ``profile_round`` times
    (which refuses the buffered-async engine). Yields ``(step, lr,
    metrics, wait_ms, t_dispatch)``."""
    spe = sampler.steps_per_epoch()
    engine = None
    if cfg.pipeline_enabled:
        from commefficient_tpu_torch.pipeline import PipelinedRounds

        engine = PipelinedRounds(cfg, session, sampler, lr_fn, stop,
                                 steps_per_epoch=spe).start(start)
    try:
        for epoch in range(start // spe, (stop - 1) // spe + 1):
            if engine is not None:
                yield from engine.epoch_rounds(epoch, start, stop)
            else:
                yield from _sync_epoch_rounds(cfg, session, sampler, lr_fn,
                                              epoch, start, stop)
    finally:
        if engine is not None:
            engine.close()


def run_train_loop(cfg, session, sampler, hooks: WorkloadHooks, table=None,
                   on_round=None, engine_stats=None, writer=None,
                   generated_by: str = "commefficient_tpu_torch.train"):
    """Run the epochs; returns ``(final val metrics, per-round history,
    checkpoint facts)``, the facts ``{"resumed_from", "save_ms",
    "restore_ms", "bytes"}`` (the round the run resumed from, 0 for a
    fresh run; the last save's and the restore's wall ms and the last
    file's bytes, None where none happened).

    History rows are ``{"step", "lr", "loss", "ms", "data_ms"}`` (and the
    ``fedsim/*`` scalars under fedsim), filled at the drains; ``on_round``
    gets each row once it is complete, in step order. ``data_ms`` is the
    round's wait for its inputs: on the prefetch queue at depth 0, for the
    staged work at depth > 0 (the host time the thread did not hide).
    ``ms`` is the round's share of the wall clock: from its dispatch to
    the next round's dispatch, and for an epoch's last round to the end of
    the epoch's drain, so an epoch's ``ms`` sum to its training wall time
    from the first dispatch (a drain and a save before a checkpoint fall
    in the round they follow). ``engine_stats``, a dict, receives the
    pipelined engine's ``stats()`` at depth > 0. ``writer`` is rank 0's
    ``MetricsWriter`` (None on the other ranks, and for no metrics file);
    ``generated_by`` names the entry point in the run's reports.

    In a worker group every rank draws the same rounds (same sampler
    seed) and trains; rank 0 alone evaluates, prints and writes
    checkpoints and telemetry (under FSDP every rank first takes part in
    the params' gather), and the other ranks return empty val metrics.
    Epochs wholly before the resumed round are skipped, evaluation
    included."""
    main = session.group.rank == 0
    steps_per_epoch = sampler.steps_per_epoch()
    num_rounds = steps_per_epoch * cfg.num_epochs
    if session.fedsim_env is not None:
        # only here is the run length known (it derives from the dataset)
        session.fedsim_env.validate_rounds(num_rounds)
        if main:
            print(session.fedsim_env.describe())
    lr_fn = partial(piecewise_linear_lr, steps_per_epoch=steps_per_epoch,
                    pivot_epoch=cfg.pivot_epoch, num_epochs=cfg.num_epochs,
                    lr_scale=cfg.lr_scale)
    # the control plane's controller (None without it), over the run's
    # length (max_rounds stops a run early; it does not shorten the
    # schedule a resumed run goes on with): before the riders and any
    # restore
    controller = build_controller(cfg, session, num_rounds=num_rounds)
    if controller is not None:
        controller.prewarm()
        if main:
            print(controller.describe())
    ledger, flight = build_telemetry_riders(cfg, session, writer)
    if flight is None and cfg.telemetry_level >= 1:
        # every rank drains the same scalars, so every rank stops at the
        # same divergence; only rank 0's recorder writes
        flight = FlightRecorder(cfg)
    profiler = StepProfiler(cfg.profile_dir if main else "")
    if cfg.profile_rounds and main:
        window_dir = cfg.profile_dir or os.path.join(
            writer.logdir if writer is not None else cfg.logdir,
            "profile_rounds")
        # fenced on the params: the rounds queued before the window finish
        # before its trace starts, and its own rounds before it stops
        profiler = ProfilerStack(profiler, ProfilerWindow(
            cfg.profile_rounds, window_dir,
            fence_fn=lambda: fence(session.state.params_vec)))
    spans, _ = build_perf_observability(cfg, session, writer, generated_by)
    # the self-healing layer (None unless a recovery policy or a preemption
    # source is set): after the riders (a recovery rewinds the ledger and
    # the flight ring), before the restore (the baseline snapshot holds
    # the restored state)
    resil = build_resilience(cfg, session, sampler, ledger=ledger,
                             flight=flight)
    if resil is not None and main:
        print(resil.describe())

    def before_dispatch(s):
        profiler.step(s)
        if spans is not None:
            spans.step(s)

    def span(name, trace_id=None):
        return (spans.span(name, trace_id=trace_id) if spans is not None
                else nullcontext())

    checkpointer = FedCheckpointer(cfg)
    start = 0
    engine = None
    try:
        if cfg.resume:
            restored = checkpointer.restore(session)
            if restored is not None:
                start = restored
                profiler.resume_at(start)
                if spans is not None:
                    spans.resume_at(start)
                if main:
                    print(f"resumed from checkpoint at round {start}")
        last = (min(num_rounds, cfg.max_rounds) if cfg.max_rounds
                else num_rounds)
        if cfg.pipeline_enabled and start < last:
            from commefficient_tpu_torch.pipeline import PipelinedRounds

            # built after the restore: its window starts at the resumed
            # round
            engine = PipelinedRounds(cfg, session, sampler, lr_fn, last,
                                     steps_per_epoch=steps_per_epoch
                                     ).start(start)
        elif cfg.asyncfed_enabled and start < last:
            from commefficient_tpu_torch.asyncfed import AsyncFederation

            # after the restore too (its window rebuilds at the resumed
            # update); its schedule spans the whole run, so a resumed run
            # with a larger max_rounds follows the same script
            engine = AsyncFederation(cfg, session, sampler, lr_fn,
                                     num_rounds,
                                     steps_per_epoch=steps_per_epoch
                                     ).start(start)
            if main:
                print(f"asyncfed: buffer K={cfg.async_buffer} concurrency "
                      f"C={cfg.async_concurrency} staleness_exponent="
                      f"{cfg.staleness_exponent:g} (K=W, C=1, exponent 0 "
                      "== the synchronous round, bit-exact)")
        if resil is not None:
            # a divergence before the first snapshot_every boundary rolls
            # back to the start round
            resil.baseline(start)
    except BaseException:
        # the finally below is not reached: join the worker and restore
        # the signal dispositions here
        if engine is not None:
            engine.close()
        if resil is not None:
            resil.close()
        session.close_client_store()
        raise
    table = table or TableLogger()
    history = []
    unreported = []  # history rows not yet given to on_round
    val = {}
    live_drain = None  # the current epoch's drain (the crash flush)
    step = start  # the round the loop dispatches next
    # the last epoch whose end block (evaluation, table row, val scalars,
    # on_epoch_end) ran: a rollback may land inside it, and a retry's
    # replay, bit-equal, must not run it twice
    completed_epoch = start // steps_per_epoch - 1
    reseed = None  # {"acc", "rounds"} a mid-epoch rollback restored

    def report():
        while unreported and "loss" in unreported[0] and \
                "ms" in unreported[0]:
            row = unreported.pop(0)
            if on_round is not None and main:
                on_round(row)

    try:
        while True:  # one pass an entry: the first, and after a recovery
            try:
                for epoch in range(step // steps_per_epoch, cfg.num_epochs):
                    if epoch * steps_per_epoch >= last:
                        break
                    timer = Timer()
                    acc = hooks.new_accumulator()
                    n = 0
                    if reseed is not None:
                        # the replay starts at the snapshot: its
                        # accumulator and count stand for the rounds before
                        acc = copy.deepcopy(reseed["acc"])
                        n = reseed["rounds"]
                        reseed = None
                    pending = []  # (step, lr, metrics) not read back
                    rows = []  # their history rows, in the same order

                    def drain(_acc=acc, _pending=pending, _rows=rows):
                        filling = iter(list(_rows))
                        _rows.clear()

                        def accumulate(loss, metrics):
                            row = next(filling)
                            row["loss"] = loss
                            row.update({k: v for k, v in metrics.items()
                                        if k.startswith("fedsim/")})
                            hooks.accumulate(_acc, loss, metrics)

                        # under the newest pending round's id: the
                        # read-back waits for its device work
                        tid = (round_trace_id(_pending[-1][0]) if _pending
                               else None)
                        with span("metric_drain", trace_id=tid):
                            drain_round_metrics(_pending, writer, accumulate,
                                                ledger=ledger, flight=flight,
                                                controller=controller)

                    live_drain = drain
                    rounds = (engine.epoch_rounds(
                        epoch, step, last, before_dispatch=profiler.step)
                        if engine is not None else
                        _sync_epoch_rounds(cfg, session, sampler, lr_fn,
                                           epoch, step, last,
                                           before_dispatch=before_dispatch))
                    lr = float(lr_fn(max(step, epoch * steps_per_epoch)))
                    prev = None  # (the last row, its dispatch time)
                    with closing(rounds):  # a crash stops the producer too
                        for s, lr, metrics, wait_ms, t_disp in rounds:
                            if prev is not None:
                                prev[0]["ms"] = 1e3 * (t_disp - prev[1])
                            row = {"step": s, "lr": lr, "data_ms": wait_ms}
                            prev = (row, t_disp)
                            history.append(row)
                            unreported.append(row)
                            pending.append((s, lr, metrics))
                            rows.append(row)
                            n += 1
                            step = s + 1
                            if checkpointer.will_save(step):
                                drain()  # the losses first, then the save
                                with span("checkpoint"):
                                    checkpointer.maybe_save(session, step)
                            if resil is not None and \
                                    resil.will_snapshot(step):
                                # the drain certifies the rounds below
                                # step finite before the vault admits it
                                drain()
                                with span("snapshot"):
                                    extras = {"acc": copy.deepcopy(acc),
                                              "rounds": n}
                                    if hasattr(engine, "snapshot_extra"):
                                        # the in-flight window: the
                                        # replay reuses its launched rows
                                        extras["asyncfed"] = (
                                            engine.snapshot_extra())
                                    resil.snapshot(step, extras=extras)
                            if resil is not None and \
                                    resil.preempt_requested(metrics):
                                drain()
                                with span("checkpoint"):
                                    saved = checkpointer.enabled and (
                                        checkpointer.maybe_save(
                                            session, step, force=True)
                                        or checkpointer.latest_step()
                                        == step)
                                if writer:
                                    writer.scalar(
                                        "resilience/preempt_requested",
                                        1.0, s)
                                    writer.flush()
                                raise PreemptShutdown(
                                    step, resil.preempt_source, saved=saved)
                            report()
                    drain()
                    if prev is not None:
                        prev[0]["ms"] = 1e3 * (time.perf_counter() - prev[1])
                    report()
                    train_time = timer()
                    if epoch > completed_epoch:
                        if cfg.fsdp:  # every rank gathers what rank 0 reads
                            session.full_params_vec()
                        if main:
                            timer()
                            val = hooks.evaluate()
                            table.append(hooks.epoch_row(
                                epoch=epoch, lr=lr, acc=acc, val=val,
                                train_time=train_time, val_time=timer(),
                                rounds=max(n, 1)))
                            if writer:
                                hooks.write_val(writer, val,
                                                session.state.step)
                                writer.flush()
                            hooks.on_epoch_end(epoch, val)
                    completed_epoch = max(completed_epoch, epoch)
                break
            except DivergenceError as e:
                # roll back to the newest snapshot at or before the first
                # bad round and re-enter there; None: not recoverable, the
                # crash path below (with e.recovery_history)
                rollback = (resil.on_divergence(e) if resil is not None
                            else None)
                if rollback is None:
                    raise
                step = rollback
                live_drain = None  # its pending rounds were rolled back
                extras = resil.last_restored_extras or {}
                # a snapshot at an epoch's start re-seeds nothing
                reseed = (extras if step % steps_per_epoch and "acc" in extras
                          else None)
                for kept in (history, unreported):
                    kept[:] = [r for r in kept if r["step"] < step]
                forks = resil.manager.policy.forks
                if forks:
                    # a fork changes the replayed epochs: their end blocks
                    # run again, reporting what the healed run did
                    completed_epoch = min(completed_epoch,
                                          step // steps_per_epoch - 1)
                # the checkpoints above the rollback hold the rolled-back
                # trajectory; after a fork the rollback round's must hold
                # the fork (the demotion floor, the blacklist)
                checkpointer.discard_steps_after(step)
                if forks:
                    checkpointer.resave(session, step)
                if engine is not None:
                    if hasattr(engine, "restore_extra"):
                        # the snapshot's window, restored by the restart
                        # (none: a deterministic cold rebuild)
                        engine.restore_extra(extras.get("asyncfed"))
                    engine.restart(step)  # drop the staged window
                if main:
                    m = resil.manager
                    print(f"resilience: recovered from divergence at round "
                          f"{e.step} — rolled back to round {step} under "
                          f"policy {cfg.recover_policy!r} (recovery "
                          f"{m.recoveries}/{m.max_recoveries})", flush=True)
        # the end-of-training save: a run's last rounds past the final
        # checkpoint_every boundary would otherwise be lost to a resume
        if checkpointer.will_save(session.state.step, force=True):
            with span("checkpoint"):
                checkpointer.maybe_save(session, session.state.step,
                                        force=True)
    except Exception as e:
        # the rounds dispatched before a crash still reach the metrics, the
        # ledger and the ring (a DivergenceError from this flush names the
        # true first bad round and wins; any other flush error must not
        # hide the original one)
        if live_drain is not None and not isinstance(e, DivergenceError):
            try:
                live_drain()
            except DivergenceError:
                raise
            except Exception:  # noqa: BLE001 — the original error wins
                pass
        record_crash(flight, e)  # a divergence dumped its own record
        raise
    finally:
        if engine is not None:
            if engine_stats is not None:
                engine_stats.update(engine.stats())
            engine.close()  # joins the worker, crashes included
        profiler.close()
        if spans is not None:  # dumped on a crash too: evidence as well
            session.spans = session.audit_arm = None
            spans.close()
            if cfg.run_report:
                path = write_run_report(writer.logdir,
                                        generated_by=generated_by)
                if path:
                    print(f"run report: {path}")
        if ledger is not None:  # a partial ledger is evidence too
            ledger.write(writer.logdir)
        if resil is not None:
            resil.close()  # the signal dispositions, crashes included
        # the hosted client store's fence and its writeback worker's join
        # (an anonymous mmap file is unlinked): nothing without one
        session.close_client_store()
    return val, history, {"resumed_from": start,
                          "save_ms": checkpointer.last_save_ms,
                          "restore_ms": checkpointer.last_restore_ms,
                          "bytes": checkpointer.last_bytes}

"""PipelinedRounds — the runner's round source at ``pipeline_depth > 0``
(the port's copy of ``commefficient_tpu/pipeline/engine.py``).

The round's kernels are launched asynchronously already; what held the
loop were the steps before the launch: the sampler's draw and batch
assembly, the fedsim environment, the lr and the copy to the card (a
pageable ``.to(device)`` waits for the stream). This engine moves them to
the ``RoundPrefetcher``'s worker, ``pipeline_depth`` rounds ahead, and
keeps the dispatch order, and with it the values, those of the synchronous
loop: the rounds dispatch in step order through the session's own entries
(``train_round`` / ``train_round_indices`` with the staged tensors and
their event; with a hosted client store, the staged cohort rows, which the
session gathers again if a round in the window wrote one of them since),
the runner's deferred drain reads the metrics at the same
points (epoch end, before a save), and a checkpoint holds only the state
of dispatched rounds: the window holds pure inputs of future rounds, so a
resume restarts it at the restored round.

``stats()`` gives the means over the rounds run: ``occupancy`` (rounds
staged ahead at each fetch over the depth), ``host_stall_ms`` (the
consumer's wait for staged work: the host time the depth did not hide),
``prefetch_host_ms`` (the worker's time a round), and the count
``staged_copies`` of rounds whose arrays came staged on the card (every
round on the card, none on the CPU). With the session's span recorder
attached (telemetry level >= 1) the round clock ``spans.step`` moves
before each dispatch, the worker records its lane, and each round's
metrics carry ``pipeline/occupancy``, ``pipeline/host_stall_ms`` and
``pipeline/staged_rounds`` (host floats; ``run_report.json``'s stall
anomaly reads them).

The control plane's decision point needs no barrier here: the session's
``_round`` runs ``on_round_start`` before each dispatch, and the staged
inputs (batch, fedsim masks, lr) do not depend on the rung, so a switch
invalidates nothing in the window. The engine registers a rung-switch
listener (``_on_rung_switch``) that counts each switch as a quiesce
(``stats()["quiesces"]``) and records a ``pipeline_quiesce:rungA->rungB``
span; nothing is restaged.

A resilience/ recovery rewinds the state to a snapshot: ``restart(step)``
then stops and joins the worker, drops the staged window (future rounds
of the rolled-back trajectory) and starts a new one at the rollback round,
whose rounds below the session's replay horizon realize their environment
with ``replay=True``; ``stats()["restarts"]`` counts them.
"""

from __future__ import annotations

import time
from typing import Optional

from commefficient_tpu_torch.pipeline.prefetch import RoundPrefetcher


class PipelinedRounds:
    """One per train loop when ``cfg.pipeline_depth > 0``. ``lr_fn`` is the
    loop's schedule (pure in the round), ``num_rounds`` the last round
    (exclusive) the run dispatches."""

    def __init__(self, cfg, session, sampler, lr_fn, num_rounds: int,
                 steps_per_epoch: Optional[int] = None):
        if cfg.pipeline_depth < 1:
            raise ValueError(
                "PipelinedRounds needs cfg.pipeline_depth >= 1 (depth 0 is "
                "the synchronous loop: build nothing)")
        self.cfg = cfg
        self.session = session
        self.depth = int(cfg.pipeline_depth)
        self.num_rounds = int(num_rounds)
        self.steps_per_epoch = int(steps_per_epoch if steps_per_epoch
                                   is not None else sampler.steps_per_epoch())
        self._use_idx = session.data_path == "device"
        self._sampler = sampler
        self._lr_fn = lr_fn
        self._prefetcher: Optional[RoundPrefetcher] = None
        self._rounds = 0
        self._stall_ms_sum = 0.0
        self._occupancy_sum = 0.0
        self._host_ms_sum = 0.0
        self._staged_copies = 0
        self.quiesces = 0
        self.restarts = 0
        if session.controller is not None:
            session.controller.add_switch_listener(self._on_rung_switch)

    def start(self, resume_step: int = 0) -> "PipelinedRounds":
        """Start the run-long prefetcher at ``resume_step``, the round the
        loop dispatches next (a resumed run's restored round)."""
        if self._prefetcher is None:
            self._prefetcher = self._build_prefetcher(resume_step)
        return self

    def _build_prefetcher(self, step: int) -> RoundPrefetcher:
        return RoundPrefetcher(
            session=self.session, sampler=self._sampler, lr_fn=self._lr_fn,
            depth=self.depth, start_step=int(step),
            stop_step=self.num_rounds, use_indices=self._use_idx,
            spans=self.session.spans,
            # the rounds the session has run realize as replays
            replay_until=self.session._replay_horizon).start()

    def restart(self, step: int) -> None:
        """A recovery's fence: the staged window holds rounds of the
        trajectory a rollback just rewound, so stop and join the worker,
        drop its work and stage again from ``step``, the rollback round,
        with the session's replay horizon."""
        if self._prefetcher is None:
            raise RuntimeError("PipelinedRounds.restart before start()")
        self._prefetcher.close()
        self._prefetcher = self._build_prefetcher(step)
        self.restarts += 1
        spans = self.session.spans
        if spans is not None:
            with spans.span(f"pipeline_recovery_restart:round{int(step)}",
                            step=int(step)):
                pass

    def close(self) -> None:
        """Stop and join the prefetch worker (the runner calls this on
        every exit, crashes included)."""
        if self._prefetcher is not None:
            self._prefetcher.close()

    def epoch_rounds(self, epoch: int, start_step: int, stop_step: int,
                     before_dispatch=None):
        """Yield ``(step, lr, metrics, wait_ms, t_dispatch)`` for epoch
        ``epoch``'s rounds in ``[max(start_step, epoch start),
        min(stop_step, epoch end))``, each dispatched through the session
        as the synchronous loop dispatches it (``before_dispatch(step)``
        just before, when given); ``wait_ms`` is the wait for its staged
        work, ``t_dispatch`` the ``perf_counter`` time of the dispatch."""
        if self._prefetcher is None:
            raise RuntimeError("PipelinedRounds.epoch_rounds before start()")
        spe = self.steps_per_epoch
        for step in range(max(epoch * spe, start_step),
                          min((epoch + 1) * spe, stop_step)):
            staged = self._prefetcher.staged_rounds
            t0 = time.perf_counter()
            work = self._prefetcher.get(step)  # re-raises worker faults
            t_disp = time.perf_counter()
            stall_ms = (t_disp - t0) * 1e3
            if before_dispatch is not None:
                before_dispatch(step)
            spans = self.session.spans
            if spans is not None:
                spans.step(step)
            metrics = self._dispatch(work)
            occupancy = staged / self.depth
            self._rounds += 1
            self._stall_ms_sum += stall_ms
            self._occupancy_sum += occupancy
            self._host_ms_sum += work.host_ms
            self._staged_copies += work.ready is not None
            if self.cfg.telemetry_level >= 1:
                # the same keys every round, as pack_metric_dicts requires
                metrics = {**metrics,
                           "pipeline/occupancy": float(occupancy),
                           "pipeline/host_stall_ms": float(stall_ms),
                           "pipeline/staged_rounds": float(staged)}
            yield step, work.lr, metrics, stall_ms, t_disp

    def _dispatch(self, work):
        sess = self.session
        if self._use_idx:
            return sess.train_round_indices(work.client_ids, work.idx,
                                            work.plan, work.lr, env=work.env,
                                            ready=work.ready)
        return sess.train_round(work.client_ids, work.batch, work.lr,
                                env=work.env, ready=work.ready,
                                cohort=work.cohort, host_ids=work.host_ids)

    def _on_rung_switch(self, step: int, old: int, new: int) -> None:
        """The controller's switch listener: the staged window needs no
        restaging (its inputs do not depend on the rung), so the quiesce
        is a count and a span marker, not a flush."""
        self.quiesces += 1
        spans = self.session.spans
        if spans is not None:
            with spans.span(f"pipeline_quiesce:rung{old}->rung{new}",
                            step=step):
                pass

    def stats(self) -> dict:
        n = max(self._rounds, 1)
        return {"rounds": self._rounds,
                "occupancy": self._occupancy_sum / n,
                "host_stall_ms": self._stall_ms_sum / n,
                "prefetch_host_ms": self._host_ms_sum / n,
                "staged_copies": self._staged_copies,
                "quiesces": self.quiesces,
                "restarts": self.restarts}

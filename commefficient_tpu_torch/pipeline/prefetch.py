"""RoundPrefetcher — realize round t+1..t+depth's host work off the
critical path (the port's copy of ``commefficient_tpu/pipeline/
prefetch.py``).

One worker thread walks the global round index (the sampler, the fedsim
environment and the lr schedule are pure functions of the round; epochs are
bookkeeping), realizing one ``RoundWork`` a round:

* the sampler's draw and batch assembly (the native gather writing straight
  into the staging ring's pinned buffers), or the index form on the
  device-resident training set;
* fedavg's ``[W, L, B, ...]`` reshape;
* the round's fedsim ``RoundEnv`` (with ``replay=True`` below
  ``replay_until``: a round re-executed after a rollback), with the
  session's blacklist composed in on the host client ids;
* the schedule's lr;
* the early copy to the card (``FederatedSession.stage_round_payload`` /
  ``stage_round_indices``): the worker owns its ``RoundStager``, its side
  stream and pinned rings, and each ``RoundWork`` carries the event the
  dispatch waits on.

Realizing ahead commutes with running the rounds, so the stream of
``RoundWork`` equals what the synchronous loop realizes, in order. The
queue holds at most ``depth`` rounds.

Faults never hang: a worker exception is kept with its traceback and
re-raised by ``get`` at the consuming round; ``get`` polls, and raises
``PrefetchWorkerDied`` if the worker exited without delivering; ``close``
drains the queue, sets the stop flag (the worker's puts poll it) and joins
the worker, even with a full queue.

With a span recorder (``spans``, telemetry level >= 1) the worker labels
its lane ``round-prefetch`` and records each round's ``prefetch_realize``
(the draw, the fedsim environment, the lr) and ``prefetch_stage`` (the
copy to the card), stamped with the round they realize and its trace id.
Not ported (ROADMAP A11): the hosted client rows' staging.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, NamedTuple, Optional

from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.telemetry.trace import round_trace_id


class RoundWork(NamedTuple):
    """One round's realized, staged inputs. Exactly one of ``batch`` (the
    host-batch path: ``{k: [W, B, ...]}``, fedavg ``[W, L, B, ...]``) and
    ``idx`` (the index path, with ``plan`` the augment plan's arrays) is
    set; on the card they are device tensors and ``ready`` the event after
    their copies (None on the CPU). ``env`` is the round's fedsim
    ``RoundEnv`` (None without fedsim); ``host_ms`` the worker's wall time
    realizing and staging the round, the host time moved off the critical
    path."""

    step: int
    lr: float
    client_ids: Any
    batch: Optional[dict]
    idx: Any
    plan: Any
    env: Any
    ready: Any
    host_ms: float


_END = object()


class PrefetchWorkerDied(RuntimeError):
    """The prefetch worker exited without delivering the next round or an
    exception: a bug in the worker loop, surfaced instead of a hang."""


class RoundPrefetcher:
    """Realizes ``RoundWork`` for rounds ``[start_step, stop_step)`` on a
    worker thread, at most ``depth`` ahead of the consumer. ``use_indices``
    selects the index form (the device-resident training set); ``spans``
    a ``PhaseSpans`` for the worker's lane, or None."""

    def __init__(self, *, session, sampler, lr_fn, depth: int,
                 start_step: int = 0, stop_step: int = 0,
                 use_indices: bool = False, spans=None,
                 replay_until: int = 0):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.session = session
        self.sampler = sampler
        self.lr_fn = lr_fn
        self.depth = int(depth)
        self.start_step = int(start_step)
        self.stop_step = int(stop_step)
        self.use_indices = bool(use_indices)
        self.spans = spans
        # resilience/'s replay fence: the rounds below it run again after a
        # rollback and realize their environment with replay=True (the
        # engine passes the session's horizon when it restarts the window)
        self.replay_until = int(replay_until)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        # rounds of work staged ahead (the occupancy numerator): qsize would
        # also count the end marker and a queued exception
        self._staged = 0
        self._staged_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="round-prefetch", daemon=True)
        self._started = False

    # -- worker side -------------------------------------------------------
    def _span(self, name: str, step: int):
        if self.spans is None:
            return contextlib.nullcontext()
        return self.spans.span(name, step=step, trace_id=round_trace_id(step))

    def _realize(self, step: int) -> RoundWork:
        t0 = time.perf_counter()
        sess = self.session
        with self._span("prefetch_realize", step):
            if self.use_indices:
                cids, idx, plan = self.sampler.sample_round_indices(step)
                batch = None
            else:
                cids, batch = self.sampler.sample_round(
                    step, alloc=sess.staging_alloc)
                batch = microbatched(sess.cfg, batch)
                idx = plan = None
            env = sess.fedsim_round_env(step, cids,
                                        replay=step < self.replay_until)
            lr = float(self.lr_fn(step))
        with self._span("prefetch_stage", step):
            if self.use_indices:
                cids, idx, plan, ready = sess.stage_round_indices(cids, idx,
                                                                  plan)
            else:
                cids, batch, ready = sess.stage_round_payload(cids, batch)
        return RoundWork(step=step, lr=lr,
                         client_ids=cids, batch=batch, idx=idx, plan=plan,
                         env=env, ready=ready,
                         host_ms=(time.perf_counter() - t0) * 1e3)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            if self.spans is not None:
                self.spans.register_lane("round-prefetch")
            for step in range(self.start_step, self.stop_step):
                if self._stop.is_set():
                    return
                if not self._put(self._realize(step)):
                    return
                with self._staged_lock:
                    self._staged += 1
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._put(e)

    # -- consumer side -----------------------------------------------------
    def start(self) -> "RoundPrefetcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def get(self, step: int) -> RoundWork:
        """The next staged round, which must be ``step`` (a mismatch means
        the consumer and the worker disagree about the round clock).
        Re-raises a worker exception with its traceback; raises
        ``PrefetchWorkerDied`` instead of hanging when the worker is
        gone."""
        if not self._started:
            raise RuntimeError("RoundPrefetcher.get before start()")
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # its last item may have landed between the timeout and
                    # the liveness check: look once more before declaring
                    # it dead, or its real exception would be masked
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        raise PrefetchWorkerDied(
                            f"prefetch worker died before staging round "
                            f"{step} (no item, no exception)") from None
        if item is _END:
            raise PrefetchWorkerDied(
                f"prefetch exhausted at round {step}: the worker covered "
                f"[{self.start_step}, {self.stop_step}) and the consumer "
                "asked past it")
        if isinstance(item, BaseException):
            raise item  # its traceback holds the worker's frames
        if item.step != step:
            raise RuntimeError(f"prefetch order violated: staged round "
                               f"{item.step}, consumer expected {step}")
        with self._staged_lock:
            self._staged -= 1
        return item

    @property
    def staged_rounds(self) -> int:
        """Rounds of work staged ahead now (0..depth)."""
        with self._staged_lock:
            return min(max(self._staged, 0), self.depth)

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the worker and join it; True when the join completed. The
        queue is drained first, so a worker blocked on a full queue wakes
        at once (its puts also poll the stop flag)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=timeout)
            return not self._thread.is_alive()
        return True

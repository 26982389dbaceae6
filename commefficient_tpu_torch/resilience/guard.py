"""PreemptGuard — preemption-safe shutdown, checked once a round (the
port's copy of ``commefficient_tpu/resilience/guard.py``).

A preempted machine (or a ctrl-C'd run) loses every round since the last
``checkpoint_every`` boundary. The guard turns the two preemption sources
into ONE flag the runner reads once a round:

  * OS signals: SIGTERM/SIGINT riders installed iff ``--preempt_signals``
    (off by default: no handler is installed, and ``close`` restores the
    previous dispositions). The handler only sets the flag; the drain, the
    checkpoint and the artifacts happen on the main thread at the next
    round boundary, where the state is consistent.
  * the fedsim chaos event ``preempt@R``, the deterministic twin: the
    round's ``fedsim/preempt`` host scalar requests the same shutdown, so
    a test is seeded, not timed.

On a request the runner drains the pending metrics, force-saves a
checkpoint (``maybe_save(force=True)``), lets the crash path write the
flight record, the ledger and the spans, and raises ``PreemptShutdown``;
the train entries turn it into the exit code ``EXIT_PREEMPTED`` (75,
sysexits' EX_TEMPFAIL), so an orchestrator can tell "preempted, resume
me" from "crashed". ``--resume`` from the forced checkpoint reproduces the
unbroken run bit for bit.
"""

from __future__ import annotations

import signal
from typing import Optional

# sysexits EX_TEMPFAIL, "temporary failure, retry later": a preempted and
# checkpointed run. Distinct from 0 (done) and 1 (crash)
EXIT_PREEMPTED = 75


class PreemptShutdown(RuntimeError):
    """Raised by the runner once a preemption request was honored: the
    metrics drained and, when checkpointing is configured, a checkpoint
    force-saved at round ``step`` (``saved`` says whether one exists; the
    message never claims a checkpoint that was not written). The train
    entries exit with ``EXIT_PREEMPTED`` either way: without a
    checkpoint_dir the preemption is still a temporary failure, only not a
    resumable one."""

    def __init__(self, step: int, source: Optional[str],
                 saved: bool = True):
        self.step = int(step)
        self.source = source or "unknown"
        self.saved = bool(saved)
        if self.saved:
            what = (f"drained metrics and force-saved a checkpoint at "
                    f"round {self.step} — rerun with --resume to continue "
                    "bit-exactly")
        else:
            what = (f"drained metrics at round {self.step} but NO "
                    "checkpoint was saved (checkpointing is disabled — "
                    "set --checkpoint_dir to make preemption resumable); "
                    "a rerun starts from round 0")
        super().__init__(
            f"preemption requested ({self.source}); {what} "
            f"(exit code {EXIT_PREEMPTED})")


class PreemptGuard:
    """The shutdown flag. Only ``install_signals=True`` touches the
    process's signal table, and ``close`` restores it."""

    def __init__(self, install_signals: bool = False):
        self.requested = False
        self.source: Optional[str] = None
        self._installed = []
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev = signal.signal(sig, self._on_signal)
                except (ValueError, OSError):
                    # not the main thread: the chaos and explicit requests
                    # still work
                    continue
                self._installed.append((sig, prev))

    @property
    def signals_installed(self) -> bool:
        return bool(self._installed)

    def _on_signal(self, signum, frame) -> None:
        # the flag only: no I/O, no device work (the runner acts at the
        # next round boundary, on the main thread)
        self.request(f"signal {signal.Signals(signum).name}")

    def request(self, source: str) -> None:
        """Set the flag (idempotent; the first source wins)."""
        if not self.requested:
            self.requested = True
            self.source = source

    def check_metrics(self, metrics) -> bool:
        """Fold one round's metric dict into the flag: ``preempt@R`` rides
        as the host scalar ``fedsim/preempt``, so reading it syncs
        nothing. Returns the flag."""
        if not self.requested and metrics:
            v = metrics.get("fedsim/preempt", 0.0)
            if isinstance(v, (int, float)) and float(v) > 0.0:
                self.request("chaos preempt@round")
        return self.requested

    def close(self) -> None:
        """Restore the previous signal dispositions (the runner's finally
        block, crashes included)."""
        for sig, prev in self._installed:
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._installed = []

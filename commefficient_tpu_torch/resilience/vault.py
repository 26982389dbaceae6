"""RollbackVault — drain-certified FedState snapshots in host memory (the
port's copy of ``commefficient_tpu/resilience/vault.py``).

A divergence is detected at a DRAIN (the flight recorder's check), up to
a drain interval after the first bad round, so a recovery needs a state
image from before that round, without a disk round trip a boundary. The
vault keeps the last few snapshots in host memory, each a COPY of every
``FedState`` leaf in ``full_state``'s layout (the checkpoint's: params,
momentum, error, both client banks, ``step``, ``comp``), the controller's
blob and the ``CommLedger``'s counters, and restores them through
``utils.checkpoint.commit_fed_state``, the leaf commit the checkpoint
restore uses: a sharded leaf back to each rank's slice, every other leaf
onto the session's device.

The certainty the runner leans on: it drains right before every
``snapshot``, the drain checks the rounds in step order, and a raising
drain never reaches the snapshot. So every snapshot covers only rounds
certified finite, and a snapshot with ``step <= first_bad_step`` always
exists (the runner seeds the baseline at its start round).

A capture copies the state to the host, which waits for the rounds in
flight: a sync point paid only with ``--recover_policy`` on, once every
``--snapshot_every`` rounds.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Snapshot:
    """One drain-certified state image at a round boundary: the state the
    run had BEFORE round ``step`` dispatched."""

    step: int
    fed_state: Dict[str, Any]  # leaf -> host tensor | None | the int step
    control: Optional[np.ndarray]  # the controller's blob (float64)
    ledger: Optional[dict]  # CommLedger.snapshot_state()
    captured_at: float  # wall clock, for the post-mortem only
    # the runner's host rider, stored as given (the caller passes copies)
    # and handed back after a rollback to this snapshot
    extras: Optional[Dict[str, Any]] = None

    @property
    def nbytes(self) -> int:
        out = sum(t.numel() * t.element_size()
                  for t in self.fed_state.values() if torch.is_tensor(t))
        if self.control is not None:
            out += self.control.nbytes
        return out


class RollbackVault:
    """A ring of the last ``keep`` snapshots, one every ``snapshot_every``
    rounds (and the baseline the runner seeds at its start round)."""

    def __init__(self, snapshot_every: int, keep: int = 2):
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.snapshot_every = int(snapshot_every)
        self.keep = int(keep)
        self._snaps: deque = deque(maxlen=self.keep)
        self.captures = 0
        self.restores = 0

    def __len__(self) -> int:
        return len(self._snaps)

    def will_snapshot(self, step: int) -> bool:
        """True iff the runner drains and snapshots at round boundary
        ``step`` (the checkpoint's ``will_save`` rule)."""
        return step > 0 and step % self.snapshot_every == 0

    def snapshot(self, session, step: int, ledger=None,
                 extras: Optional[Dict[str, Any]] = None) -> Snapshot:
        """Capture the session's state at boundary ``step`` (every rank
        calls it: gathering a sharded leaf is a collective). Capturing a
        boundary again (a replayed window after a rollback) replaces its
        entry in place."""
        st = session.full_state() if session.sharded_leaves else \
            session.state
        # copies, never views: the round updates the client banks in place
        fs = {f: (v.detach().to("cpu", copy=True) if torch.is_tensor(v)
                  else v) for f, v in vars(st).items()}
        controller = session.controller
        snap = Snapshot(
            step=int(step), fed_state=fs,
            control=(None if controller is None
                     else np.array(controller.state_blob(), copy=True)),
            ledger=(ledger.snapshot_state() if ledger is not None else None),
            captured_at=time.time(), extras=extras)
        self.captures += 1
        if self._snaps and self._snaps[-1].step == snap.step:
            self._snaps[-1] = snap
        else:
            self._snaps.append(snap)
        return snap

    def latest(self, max_step: Optional[int] = None) -> Optional[Snapshot]:
        """The newest snapshot at or before ``max_step`` (None: the
        newest)."""
        for snap in reversed(self._snaps):
            if max_step is None or snap.step <= max_step:
                return snap
        return None

    def restore(self, session, snap: Snapshot, ledger=None) -> int:
        """Rewind ``session`` (and ``ledger``) to ``snap`` in place; returns
        the snapshot's step. The checkpoint restore's order: the saved rung
        is activated first (the dispatch only: the leaves are already in
        its layout, so nothing migrates), then the leaves are committed,
        the controller's blob and the ledger's counters loaded, and the
        round clock re-synced."""
        from commefficient_tpu_torch.utils.checkpoint import commit_fed_state

        controller = session.controller
        if controller is not None and snap.control is not None:
            saved_rung = int(snap.control[1])
            if 0 <= saved_rung < len(session.rungs):
                session.set_active_rung(saved_rung, migrate=False)
        commit_fed_state(session, snap.fed_state)
        if controller is not None and snap.control is not None:
            controller.load_state_blob(snap.control)
        if ledger is not None and snap.ledger is not None:
            ledger.load_snapshot_state(snap.ledger)
        # the replay horizon is NOT rewound: the rounds below it run again
        # with replay=True
        session.sync_round_clock()
        self.restores += 1
        return snap.step

"""RecoveryManager and ResilienceRider — what ``train/runner.py`` sees (the
port's copy of ``commefficient_tpu/resilience/manager.py``).

One ``build_resilience`` call a train loop (as ``fedsim.build_environment``
and ``control.build_controller``): it returns None unless a recovery
policy or a preemption source is configured, so the default run builds
nothing: no vault, no signal handler, no ``resilience/*`` scalars.

The manager's recovery, on a caught ``DivergenceError``:

  1. bounds — ``--max_recoveries`` spent: attach the history to the error
     and give up (the runner re-raises it);
  2. target — the newest vault snapshot with ``step <= first_bad_step``
     (drain-certified, see vault.py; the baseline makes one exist);
  3. check — the policy's applicability, before anything is rewound;
  4. rewind — the session's state, the controller's blob and the ledger's
     counters from the snapshot, and the flight ring past the rollback
     round (the detection's dump kept the diverged rounds);
  5. apply — the policy's repair (policy.py);
  6. history — append the entry, write the ``_recovery``-tagged flight
     dump carrying it, and hand the rollback round to the runner, which
     restarts its round source there (the pipelined engine drops its
     staged window).

The ``resilience/*`` scalars ride every round's metric dict (the session
appends ``scalars()``), the same keys every round, as
``pack_metric_dicts`` requires.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from commefficient_tpu_torch.resilience.guard import PreemptGuard
from commefficient_tpu_torch.resilience.policy import (
    RecoveryUnavailable,
    get_recovery_policy,
)
from commefficient_tpu_torch.resilience.vault import RollbackVault


class RecoveryManager:
    """Owns the vault, the policy, the counters and the history."""

    def __init__(self, cfg, session, sampler, ledger=None, flight=None):
        self.cfg = cfg
        self.session = session
        self.sampler = sampler
        self.ledger = ledger
        self.flight = flight
        self.policy = get_recovery_policy(cfg)
        self.vault = RollbackVault(cfg.snapshot_every)
        self.max_recoveries = int(cfg.max_recoveries)
        self.recoveries = 0
        self.rung_demotions = 0
        self.last_rollback_round = -1  # -1: never rolled back
        self.last_restored_extras: Optional[Dict] = None
        self.history: List[Dict] = []
        self._suspects = None  # (step, ids): suspect_clients' memo

    # -- snapshots ------------------------------------------------------------
    def will_snapshot(self, step: int) -> bool:
        return self.vault.will_snapshot(step)

    def snapshot(self, step: int, extras: Optional[Dict] = None) -> None:
        """Capture a boundary snapshot. The runner MUST have drained right
        before (the drain certifies the rounds below ``step`` finite: the
        vault's whole argument). ``extras`` (the runner's epoch
        accumulator) comes back as ``last_restored_extras`` after a
        rollback to this snapshot."""
        self.vault.snapshot(self.session, step, ledger=self.ledger,
                            extras=extras)

    def baseline(self, step: int, extras: Optional[Dict] = None) -> None:
        """Seed the vault at the loop's start round (after a restore), so a
        divergence before the first ``snapshot_every`` boundary is still
        recoverable."""
        self.snapshot(step, extras=extras)

    # -- the recovery ---------------------------------------------------------
    def on_divergence(self, exc) -> Optional[int]:
        """Try to recover from ``exc`` (a ``telemetry.DivergenceError``).
        Returns the round to re-enter the loop at, or None when the run
        must die; ``exc.recovery_history`` then holds the history."""
        entry = {
            "recovery": self.recoveries + 1,
            "policy": self.cfg.recover_policy,
            "first_bad_step": int(exc.step),
            "reason": str(getattr(exc, "reason", exc))[:200],
        }
        if getattr(exc, "path", None):
            entry["flight_dump"] = exc.path
        if self.recoveries >= self.max_recoveries:
            entry["outcome"] = (
                f"exhausted ({self.recoveries}/{self.max_recoveries} "
                "recoveries already spent)")
            return self._give_up(exc, entry)
        snap = self.vault.latest(max_step=exc.step)
        if snap is None:
            entry["outcome"] = "no pre-divergence snapshot in the vault"
            return self._give_up(exc, entry)
        try:
            # before the rewind: a recovery that gives up must leave the
            # ledger and the flight ring describing what ran
            self.policy.check(self.session, self, exc, snap)
        except RecoveryUnavailable as e:
            entry["outcome"] = f"policy unavailable: {e}"
            return self._give_up(exc, entry)
        self.vault.restore(self.session, snap, ledger=self.ledger)
        if self.flight is not None:
            self.flight.rewind(snap.step)
        try:
            details = self.policy.apply(self.session, self, exc) or {}
        except RecoveryUnavailable as e:
            entry["outcome"] = f"policy unavailable: {e}"
            return self._give_up(exc, entry)
        self.recoveries += 1
        self.last_rollback_round = int(snap.step)
        self.last_restored_extras = snap.extras
        entry["outcome"] = "recovered"
        entry["rollback_to"] = int(snap.step)
        # an elastic-fleet shrink recovery (duck-typed on the error, so
        # FleetShrinkError needs no import here): the session's counter
        # feeds the fleet/shrink_recoveries scalar, and the entry names
        # the width the replay re-enters at
        fleet_w = getattr(exc, "fleet_width", None)
        if fleet_w is not None:
            self.session._fleet_shrink_recoveries += 1
            entry["fleet_width"] = int(fleet_w)
        entry.update(details)
        self.history.append(entry)
        if self.flight is not None:
            # the history on disk now (a healed run may never dump again):
            # beside the detection's dump, the rewound ring and the
            # recovery_history block
            self.flight.dump(
                exc.step,
                reason=(f"recovered from divergence at round {exc.step} "
                        f"(policy {self.cfg.recover_policy!r}, rolled "
                        f"back to round {snap.step})"),
                first_bad_step=exc.step, tag="_recovery")
        return int(snap.step)

    def _give_up(self, exc, entry) -> None:
        self.history.append(entry)
        exc.recovery_history = list(self.history)
        return None

    # -- the suspects (skip_clients) ------------------------------------------
    def suspect_clients(self, step: int) -> np.ndarray:
        """Client ids suspected of poisoning round ``step``: the corrupted
        slots when the (pure, first-execution) realization names them,
        else every live participant of the round. Memoized a step (check
        and apply both ask). Only the ids are drawn
        (``sample_round_indices``), no batch is assembled."""
        if self._suspects is not None and self._suspects[0] == step:
            return self._suspects[1]
        env = self.session.fedsim_env.round_env(step)
        # the sampler draws at the base width; a fleet round ran its first
        # width-many clients (the session's slice)
        ids = np.asarray(self.sampler.sample_round_indices(step)[0])[
            :env.live.shape[0]]
        slots = env.corrupt > 0
        if not slots.any():
            slots = env.live > 0
        out = np.unique(ids[slots].astype(np.int64))
        self._suspects = (step, out)
        return out


class ResilienceRider:
    """What the runner and the session hold: the manager (the divergence
    recovery; None with ``recover_policy='none'``) and the guard (the
    preemption; None without a source)."""

    def __init__(self, cfg, session, manager: Optional[RecoveryManager],
                 guard: Optional[PreemptGuard]):
        self.cfg = cfg
        self.session = session
        self.manager = manager
        self.guard = guard

    # -- the runner's surface -------------------------------------------------
    def will_snapshot(self, step: int) -> bool:
        return self.manager is not None and self.manager.will_snapshot(step)

    def snapshot(self, step: int, extras: Optional[Dict] = None) -> None:
        self.manager.snapshot(step, extras=extras)

    def baseline(self, step: int) -> None:
        if self.manager is not None:
            self.manager.baseline(step)

    @property
    def last_restored_extras(self) -> Optional[Dict]:
        """The ``extras`` of the snapshot the last recovery restored (None
        before any, or when it carried none)."""
        return (self.manager.last_restored_extras
                if self.manager is not None else None)

    def on_divergence(self, exc) -> Optional[int]:
        if self.manager is None:
            return None
        return self.manager.on_divergence(exc)

    def preempt_requested(self, metrics) -> bool:
        if self.guard is None:
            return False
        return self.guard.check_metrics(metrics)

    @property
    def preempt_source(self) -> Optional[str]:
        return self.guard.source if self.guard is not None else None

    @property
    def history(self) -> List[Dict]:
        """The flight recorder's ``recovery_history`` source."""
        return self.manager.history if self.manager is not None else []

    # -- telemetry ------------------------------------------------------------
    def scalars(self) -> Dict[str, float]:
        """The ``resilience/*`` host scalars of every round's metric dict,
        the same keys every round."""
        m = self.manager
        bl = self.session._client_blacklist
        return {
            "resilience/recoveries": float(m.recoveries if m else 0),
            "resilience/rollback_round": float(
                m.last_rollback_round if m else -1),
            "resilience/rung_demotions": float(m.rung_demotions if m else 0),
            "resilience/blacklisted_clients": float(
                0 if bl is None else len(bl)),
            "resilience/preempt_requested": float(
                bool(self.guard is not None and self.guard.requested)),
        }

    def describe(self) -> str:
        bits = []
        if self.manager is not None:
            bits.append(f"policy={self.cfg.recover_policy}")
            bits.append(f"snapshot_every={self.cfg.snapshot_every}")
            bits.append(f"max_recoveries={self.cfg.max_recoveries}")
        if self.guard is not None:
            bits.append("preempt_guard=" + ("signals+chaos"
                                            if self.guard.signals_installed
                                            else "chaos"))
        return "resilience: " + " ".join(bits)

    def close(self) -> None:
        """The runner's finally block: restore the signal dispositions."""
        if self.guard is not None:
            self.guard.close()


def build_resilience(cfg, session, sampler, ledger=None,
                     flight=None) -> Optional[ResilienceRider]:
    """The one construction gate: a rider iff a recovery policy or a
    preemption source is configured; None leaves every caller, and the
    process's signal table, as they were. The rider is attached to the
    session (its ``resilience/*`` scalars) and to the flight recorder (its
    dumps' ``recovery_history``)."""
    from commefficient_tpu_torch.fedsim.faults import has_preempt

    want_recovery = bool(cfg.recovery_enabled)
    want_signals = bool(cfg.preempt_signals)
    env = session.fedsim_env
    want_chaos_preempt = has_preempt(env.plan if env is not None else ())
    if not (want_recovery or want_signals or want_chaos_preempt):
        return None
    manager = (RecoveryManager(cfg, session, sampler, ledger=ledger,
                               flight=flight) if want_recovery else None)
    guard = (PreemptGuard(install_signals=want_signals)
             if want_signals or want_chaos_preempt else None)
    rider = ResilienceRider(cfg, session, manager, guard)
    session.resilience = rider
    if flight is not None:
        flight.resilience = rider
    return rider

"""Recovery policies — what to CHANGE after a divergence rollback (the
port's copy of ``commefficient_tpu/resilience/policy.py``).

One class a ``--recover_policy`` value behind ``POLICIES``, as compress/
and control/ register theirs; the recovery-policy string is dispatched here
(and checked in ``utils/config.py``) only.

Every policy runs on the host AFTER the vault restored the pre-divergence
snapshot (so ``demote`` migrates the RESTORED state down the ladder, not
the diverged one) and BEFORE the runner re-enters the round loop. ``apply``
returns a jsonable dict for the recovery's history entry, or raises
``RecoveryUnavailable`` when the policy cannot act; the manager then gives
up and the original ``DivergenceError`` is re-raised with the history.

  * ``retry``        — change nothing: the replay is the repair. fedsim
                       realizes a re-executed round with ``replay=True``,
                       which suppresses the ``nan_client`` injection, so
                       a healed run is BIT-EQUAL to the unbroken one.
  * ``demote``       — ``BudgetController.demote``: floor the control/
                       ladder one rung cheaper and switch now, through
                       ``set_active_rung`` and ``migrate_state`` (the
                       rungs' kernel plans were built by the prewarm, so
                       the switch builds none). A fork: the healed run is
                       not the unbroken one, and its history says so.
  * ``skip_clients`` — blacklist the bad round's suspect client ids (the
                       corrupted slots when the realization names them,
                       else every live participant of that round) from
                       every later round's participation mask
                       (``FederatedSession.blacklist_clients``). Also a
                       fork; the server renormalizes by the reduced live
                       count, as fedsim's masking does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class RecoveryUnavailable(RuntimeError):
    """The selected policy cannot act on this session or failure (a
    demotion with no cheaper rung left, a round with no suspect to
    blacklist). The manager gives up and the original DivergenceError is
    re-raised."""


class RecoveryPolicy:
    """One ``--recover_policy``. Stateless: the manager owns the counters
    and the history."""

    name = "?"
    # True for a policy whose apply() changes state a replay would not
    # reproduce (the demotion floor, the blacklist): the runner then
    # re-saves the rollback round's checkpoint, so a crash before the next
    # boundary resumes WITH the fork. retry changes nothing, so its replay
    # re-creates the discarded checkpoints bit for bit
    forks = False

    def check(self, session, manager, exc, snap) -> None:
        """Raise RecoveryUnavailable, with no side effect, if the policy
        will not be able to act. The manager calls it BEFORE the rewind
        (vault, ledger, flight ring), so a recovery that gives up leaves
        the artifacts describing what ran. ``snap`` is the snapshot the
        restore would use."""

    def apply(self, session, manager, exc) -> Optional[Dict]:
        """Act on ``session`` after the rollback; ``exc`` is the caught
        DivergenceError (``exc.step``: the first bad round). Returns the
        history entry's details; raises RecoveryUnavailable when the
        policy cannot act."""
        raise NotImplementedError


class RetryPolicy(RecoveryPolicy):
    name = "retry"

    def apply(self, session, manager, exc) -> Optional[Dict]:
        # the replay is the repair: a re-executed round's injection is
        # suppressed
        return {"action": "retry"}


def _no_controller() -> RecoveryUnavailable:
    return RecoveryUnavailable(
        "recover_policy='demote' needs the control/ ladder, but this "
        "session has no controller")


class DemotePolicy(RecoveryPolicy):
    name = "demote"
    forks = True

    def check(self, session, manager, exc, snap) -> None:
        controller = session.controller
        if controller is None:
            raise _no_controller()
        # the rung the restore will re-activate (vault.restore reads the
        # same blob slot): unavailable iff it is already the cheapest
        top = len(session.rungs) - 1
        restored = session.active_rung
        if snap is not None and snap.control is not None:
            saved = int(np.asarray(snap.control)[1])
            if 0 <= saved <= top:
                restored = saved
        # the demotion floor survives a blob load (a rollback to a snapshot
        # older than the last demotion), so apply() descends from the
        # restored rung clamped to the floor
        restored = max(restored, int(controller.min_rung))
        if restored >= top:
            raise RecoveryUnavailable(
                f"already at the cheapest rung ({top}) — no rung left "
                "to demote to")

    def apply(self, session, manager, exc) -> Optional[Dict]:
        controller = session.controller
        if controller is None:
            raise _no_controller()
        before = session.active_rung
        after = controller.demote(exc.step)
        if after == before:
            raise RecoveryUnavailable(
                f"already at the cheapest rung ({before}) — no rung left "
                "to demote to")
        manager.rung_demotions += 1
        return {"action": "demote", "from_rung": int(before),
                "to_rung": int(after)}


def _no_suspects(step: int) -> RecoveryUnavailable:
    return RecoveryUnavailable(
        f"round {step} has no suspect clients to blacklist (no live "
        "participants realized for it)")


class SkipClientsPolicy(RecoveryPolicy):
    name = "skip_clients"
    forks = True

    def check(self, session, manager, exc, snap) -> None:
        # suspect_clients is pure and memoized a step: check and apply
        # share one draw
        if manager.suspect_clients(exc.step).size == 0:
            raise _no_suspects(exc.step)

    def apply(self, session, manager, exc) -> Optional[Dict]:
        suspects = manager.suspect_clients(exc.step)
        if suspects.size == 0:
            raise _no_suspects(exc.step)
        session.blacklist_clients(suspects)
        return {"action": "skip_clients",
                "blacklisted": [int(c) for c in suspects]}


POLICIES = {
    "retry": RetryPolicy,
    "demote": DemotePolicy,
    "skip_clients": SkipClientsPolicy,
}


def available_recover_policies() -> tuple:
    """The registered policies and the 'none' gate, sorted; pinned equal
    to ``utils.config.RECOVER_POLICIES`` by the tests."""
    return tuple(sorted(set(POLICIES) | {"none"}))


def get_recovery_policy(cfg) -> RecoveryPolicy:
    """The one recover_policy dispatch (never called for 'none':
    ``build_resilience`` gates on ``cfg.recovery_enabled`` first)."""
    cls = POLICIES.get(cfg.recover_policy)
    if cls is None:
        raise ValueError(
            f"unknown recover_policy {cfg.recover_policy!r}; registered: "
            f"{available_recover_policies()}")
    return cls()

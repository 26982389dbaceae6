"""Chaos injection — scheduled faults composed on top of availability
(the reference's ``fedsim/faults.py``: the same grammar and the same draws).

Plan grammar (the ``--chaos`` flag): comma-separated events,

    kind@value[:rounds=A-B]

  * ``dropout@P[:rounds=A-B]``   — EXTRA iid dropout at probability P
                                   during rounds A..B inclusive (all
                                   rounds when omitted), composed on top
                                   of the availability model's mask.
  * ``straggler@P[:rounds=A-B]`` — each available client independently
                                   misses the aggregation deadline with
                                   probability P: excluded from the round,
                                   but — unlike a dropped client — it DID
                                   download params and compute; its local
                                   momentum/error rows carry forward
                                   unmodified either way.
  * ``nan_client@R``             — at round R, corrupt one LIVE client's
                                   payload with a non-finite injection
                                   (the first live slot; skipped if the
                                   whole round dropped).
  * ``nan_client@N:rounds=A-B``  — the counted form: corrupt the first N
                                   live slots during rounds A..B
                                   inclusive.

  * ``preempt@R``                — at round R, request a preemption-safe
                                   shutdown (``resilience/guard.py`` reads
                                   the round's ``fedsim/preempt`` scalar):
                                   drain, force-save, exit 75. It never
                                   touches the masks.

Fleet events (the elastic fleet, README "The port's elastic fleet"):

  * ``resize@W'[:rounds=A-B]``   — the fleet runs at width W' during
                                   rounds A..B (from A onward when the
                                   range is open or omitted): a scheduled
                                   transition, the session dispatches its
                                   width-W' round closure, no recovery.
  * ``leave@n`` / ``join@n``     — n workers leave (width -= n) or join
                                   (width += n) for the event's window.
  * ``shrink@W'[:rounds=A-B]``   — an unscheduled loss: round A's FIRST
                                   execution raises ``FleetShrinkError``
                                   (a ``DivergenceError``: resilience/
                                   rolls back to the newest snapshot and
                                   re-enters), and the replay runs the
                                   window at W' without raising.

  Fleet events compose in start order: the width at round r folds every
  active event over the base ``--num_workers`` (resize/shrink set,
  leave/join add), so ``leave@4:rounds=2-,join@2:rounds=6-`` runs W, W-4,
  W-2 across its three segments. ``validate_fleet`` checks the realized
  width at every boundary (positive, ``% num_devices == 0``, at most
  ``num_workers``, the width the sampler draws at).

Parsing is syntax-and-range validated here (``utils.config`` calls
``parse_chaos`` at construction); round indices against the RUN LENGTH are
validated by ``validate_chaos_rounds`` at train-entry time, because only
the train loop knows ``steps_per_epoch * num_epochs``.

``apply_chaos(..., replay=True)`` (a round re-executed after a rollback)
suppresses the ``nan_client`` injection without consuming any rng draw,
so the dropout/straggler masks stay bit-identical to the first pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

CHAOS_KINDS = ("dropout", "straggler", "nan_client", "preempt",
               "resize", "leave", "join", "shrink")
# the elastic-fleet subset: events that change the per-round fleet width
FLEET_KINDS = ("resize", "leave", "join", "shrink")
# the kinds the port runs: every kind of the reference's grammar
PORTED_KINDS = CHAOS_KINDS

_GRAMMAR = (
    'comma-separated "kind@value[:rounds=A-B]" (B empty = open-ended) '
    f'with kind in {CHAOS_KINDS}, e.g. '
    '"dropout@0.3:rounds=50-100,nan_client@120,resize@4:rounds=3-5"'
)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    kind: str  # one of CHAOS_KINDS
    # probability (dropout/straggler); the round (nan_client@R/preempt@R);
    # the client count (the counted nan_client@N:rounds=A-B form)
    value: float
    start: int  # first active round, inclusive
    end: Optional[int]  # last active round inclusive; None = open-ended
    count: int = 1  # corrupted clients per active round (nan_client only)

    def active(self, round_idx: int) -> bool:
        return self.start <= round_idx and (
            self.end is None or round_idx <= self.end
        )


def _fail(spec: str, why: str) -> ValueError:
    return ValueError(f"bad chaos plan {spec!r}: {why}. Grammar: {_GRAMMAR}")


def parse_chaos(spec: str) -> Tuple[ChaosEvent, ...]:
    """Parse a chaos plan string; '' -> (). Raises ValueError (with the
    grammar) on any syntax or range problem."""
    if not spec or not spec.strip():
        return ()
    events = []
    for raw in spec.split(","):
        ev = raw.strip()
        if "@" not in ev:
            raise _fail(spec, f"event {ev!r} lacks '@value'")
        kind, _, rest = ev.partition("@")
        kind = kind.strip()
        if kind not in CHAOS_KINDS:
            raise _fail(spec, f"unknown kind {kind!r}")
        val_s, _, opt = rest.partition(":")
        try:
            value = float(val_s)
        except ValueError:
            raise _fail(spec, f"{kind}@{val_s!r} is not a number") from None
        start, end = 0, None
        if opt:
            key, _, rng_s = opt.partition("=")
            if key.strip() != "rounds" or not rng_s:
                raise _fail(spec, f"unknown option {opt!r} on {ev!r}")
            a, sep, b = rng_s.partition("-")
            try:
                start = int(a)
                # "A-B" -> A..B inclusive; "A-" -> open-ended from A;
                # "A" -> the single round A
                end = (int(b) if b.strip() else None) if sep else start
            except ValueError:
                raise _fail(spec, f"rounds={rng_s!r} is not A-B") from None
            if start < 0 or (end is not None and end < start):
                raise _fail(spec, f"rounds={rng_s!r} is not an ascending "
                                  "non-negative range")
        count = 1
        if kind == "nan_client" and opt:
            # counted form: value is the CLIENT COUNT, rounds= the window
            if value < 1 or value != int(value):
                raise _fail(spec, f"nan_client@{val_s}:rounds=A-B takes a "
                                  "client count >= 1 before the rounds "
                                  "window")
            count = int(value)
        elif kind in ("nan_client", "preempt"):
            if opt:
                raise _fail(spec, f"{kind}@R names its round directly; "
                                  "it takes no rounds= option")
            if value < 0 or value != int(value):
                raise _fail(spec, f"{kind}@{val_s} must name a "
                                  "non-negative integer round")
            start = end = int(value)
        elif kind in FLEET_KINDS:
            # resize/shrink take the new WIDTH, leave/join a worker
            # DELTA — always a positive integer count
            if value < 1 or value != int(value):
                raise _fail(spec, f"{kind}@{val_s} must name a positive "
                                  "integer worker count")
        else:
            if not 0.0 <= value < 1.0:
                raise _fail(spec, f"{kind} probability {value} outside "
                                  "[0, 1)")
        events.append(ChaosEvent(kind, value, start, end, count))
    return tuple(events)


def validate_chaos_rounds(plan: Tuple[ChaosEvent, ...],
                          num_rounds: int) -> None:
    """Reject events that can never fire: any referenced round index must
    be < ``num_rounds`` (the run's total round count). Called by the train
    entries once steps_per_epoch is known."""
    for ev in plan:
        bad = None
        if ev.start >= num_rounds:
            bad = ev.start
        elif ev.end is not None and ev.end >= num_rounds:
            bad = ev.end
        if bad is not None:
            raise ValueError(
                f"chaos event {ev.kind}@{ev.value:g} references round "
                f"{bad}, but this run has only {num_rounds} rounds "
                f"(steps_per_epoch x num_epochs) — the event would never "
                "fire (or fire truncated); shrink the schedule or lengthen "
                "the run"
            )


def apply_chaos(
    plan: Tuple[ChaosEvent, ...],
    rng: np.random.Generator,
    round_idx: int,
    avail: np.ndarray,
    *,
    replay: bool = False,
):
    """Realize one round's chaos draws on top of ``avail`` (bool [W]).

    Returns ``(avail, straggler, corrupt)`` bool masks: ``avail`` with any
    chaos dropout applied, deadline-missing stragglers (drawn among ALL
    slots, meaningful only where available), and the corrupted-payload
    slots (the first live ``count`` of the active nan events). Draws
    happen in plan order from the shared round rng, so the realization is
    a pure function of (seed, round_idx, plan).

    ``replay=True`` (a round re-executed after a rollback) suppresses the
    nan_client injection without consuming any extra rng draws, so
    dropout/straggler masks stay bit-identical to the first pass.
    ``preempt`` and fleet events never touch the masks."""
    W = avail.shape[0]
    avail = avail.copy()
    straggler = np.zeros(W, bool)
    corrupt = np.zeros(W, bool)
    want_nan = 0
    for ev in plan:
        if not ev.active(round_idx):
            continue
        if ev.kind == "dropout":
            avail &= rng.random(W) >= ev.value
        elif ev.kind == "straggler":
            straggler |= rng.random(W) < ev.value
        elif ev.kind == "nan_client" and not replay:
            want_nan += ev.count
    if want_nan:
        live = np.flatnonzero(avail & ~straggler)
        if live.size:  # a fully-dropped round has no payload to corrupt
            corrupt[live[:want_nan]] = True
    return avail, straggler, corrupt


def preempt_requested(plan: Tuple[ChaosEvent, ...], round_idx: int) -> bool:
    """True iff a ``preempt`` event is active at ``round_idx``: the round's
    ``fedsim/preempt`` scalar, which ``resilience.PreemptGuard`` reads."""
    return any(ev.kind == "preempt" and ev.active(round_idx) for ev in plan)


def has_preempt(plan: Tuple[ChaosEvent, ...]) -> bool:
    """True iff the plan schedules any preemption: one of the gates of
    ``resilience.build_resilience``."""
    return any(ev.kind == "preempt" for ev in plan)


# --------------------------------------------------------------------------
# The elastic fleet: deterministic per-round widths.
#
# The width at round r is a pure function of (plan, num_workers, r), with
# no runtime state, so a vault rollback and a checkpoint resume land on
# the right width by evaluating the schedule at the restored step. The
# session realizes a transition by dispatching the round closure it built
# for that width (parallel/api.py); everything here is host numpy.
# --------------------------------------------------------------------------


def fleet_plan(plan: Tuple[ChaosEvent, ...]) -> Tuple[ChaosEvent, ...]:
    """The fleet events of a chaos plan, in start order (ties keep plan
    order: the fold below depends on it)."""
    evs = [ev for ev in plan if ev.kind in FLEET_KINDS]
    return tuple(sorted(evs, key=lambda ev: ev.start))


def has_fleet(plan: Tuple[ChaosEvent, ...]) -> bool:
    """True iff the plan schedules any fleet event: the gate of the
    session's per-width round closures (``Config.fleet_enabled``)."""
    return any(ev.kind in FLEET_KINDS for ev in plan)


def fleet_width_at(plan: Tuple[ChaosEvent, ...], num_workers: int,
                   round_idx: int) -> int:
    """The realized fleet width at ``round_idx``: every ACTIVE fleet event
    folded over the base ``num_workers`` in start order — resize/shrink
    SET the width, leave/join ADD a delta."""
    w = int(num_workers)
    for ev in fleet_plan(plan):
        if not ev.active(round_idx):
            continue
        n = int(ev.value)
        if ev.kind in ("resize", "shrink"):
            w = n
        elif ev.kind == "leave":
            w -= n
        else:  # join
            w += n
    return w


def fleet_boundaries(plan: Tuple[ChaosEvent, ...]) -> Tuple[int, ...]:
    """Sorted rounds where the width MAY change: round 0 and every fleet
    event's window edges (its start, and end + 1 for a closed window). The
    width is constant between consecutive boundaries."""
    marks = {0}
    for ev in fleet_plan(plan):
        marks.add(ev.start)
        if ev.end is not None:
            marks.add(ev.end + 1)
    return tuple(sorted(marks))


def fleet_transitions(plan: Tuple[ChaosEvent, ...],
                      num_workers: int) -> Tuple[Tuple[int, int], ...]:
    """The rounds where the width actually CHANGES, as sorted ``(round,
    new_width)`` pairs: the schedule behind the ``fleet/resizes`` and
    ``fleet/last_resize_round`` scalars."""
    out = []
    for r in fleet_boundaries(plan):
        if r < 1:
            continue
        w = fleet_width_at(plan, num_workers, r)
        if w != fleet_width_at(plan, num_workers, r - 1):
            out.append((r, w))
    return tuple(out)


def fleet_widths(plan: Tuple[ChaosEvent, ...],
                 num_workers: int) -> Tuple[int, ...]:
    """Every width the run realizes, the base first, then ascending: the
    widths the session builds a round closure for."""
    ws = {fleet_width_at(plan, num_workers, r) for r in
          fleet_boundaries(plan)}
    base = int(num_workers)
    ws.add(base)
    return (base,) + tuple(sorted(ws - {base}))


def fleet_shrink_at(plan: Tuple[ChaosEvent, ...],
                    round_idx: int) -> Optional[int]:
    """The width W' of a ``shrink`` event whose window OPENS at
    ``round_idx`` (else None): the session raises ``FleetShrinkError`` on
    that round's first execution; a replay runs at W' quietly."""
    for ev in fleet_plan(plan):
        if ev.kind == "shrink" and ev.start == round_idx:
            return int(ev.value)
    return None


def validate_fleet(plan: Tuple[ChaosEvent, ...], *, num_workers: int,
                   num_devices: int) -> None:
    """Reject a fleet plan whose REALIZED width breaks a session invariant
    at any boundary round, with a ``ValueError`` naming the blocker (the
    reference's words). ``Config`` calls it at construction, where the
    worker and device counts live."""
    for r in fleet_boundaries(plan):
        w = fleet_width_at(plan, num_workers, r)
        if w < 1:
            raise ValueError(
                f"fleet plan realizes width {w} at round {r} — every "
                "composed width must stay >= 1 (too many leave@n deltas?)"
            )
        if w % num_devices != 0:
            raise ValueError(
                f"fleet plan realizes width {w} at round {r}, which is "
                f"not a multiple of num_devices={num_devices} — every "
                "width must shard evenly over the fixed device mesh "
                "(the mesh never resizes; only the per-round worker "
                "multiplexing does)"
            )
        if w > num_workers:
            raise ValueError(
                f"fleet plan realizes width {w} at round {r}, above the "
                f"provisioned maximum --num_workers={num_workers} — the "
                "sampler draws cohorts at the base width, so joins can "
                "only return capacity that earlier events removed"
            )
    for ev in fleet_plan(plan):
        if ev.kind != "shrink":
            continue
        before = fleet_width_at(plan, num_workers, max(ev.start - 1, 0))
        if ev.start == 0 or int(ev.value) >= before:
            raise ValueError(
                f"shrink@{int(ev.value)}:rounds={ev.start}- must model a "
                f"LOSS: it needs a round >= 1 to roll back over and a "
                f"width strictly below the {before} in effect before it "
                "(use resize@W' for scheduled, non-faulting changes)"
            )

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

The reference's ``preempt@R`` and its elastic-fleet kinds (``resize``,
``leave``, ``join``, ``shrink``) parse here with their reference syntax;
``Config`` refuses them (ROADMAP A11: resilience/ and the width ladder).

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
# the kinds the port runs; Config refuses the others (ROADMAP A11)
PORTED_KINDS = ("dropout", "straggler", "nan_client")

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

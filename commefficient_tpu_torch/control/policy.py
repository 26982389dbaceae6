"""Host-side rung-selection policies and the byte-budget hard stop (the
port's copy of the reference's ``control/policy.py``).

A policy is pure host logic deciding WHICH ladder rung the next round
dispatches; it never touches device state (the controller owns the
migration and the dispatch). Four are registered; the policy-string
branching lives here and in ``utils/config.py``'s validation:

  * ``fixed``         — a round-range schedule (``--control_schedule
                        "0-99=2,100-=0"``): a rung per round index, the
                        control-plane analog of a piecewise lr schedule.
  * ``budget_pacing`` — spend the remaining ``--budget_mb`` evenly over
                        the remaining rounds: each round picks the most
                        expensive rung whose per-round bytes fit the
                        remaining budget over the remaining rounds, so the
                        run drops down the ladder as the ledger's
                        cumulative bytes approach the cap.
  * ``ef_feedback``   — closed loop on the error-feedback telemetry
                        (the slope of ``diag/ef_residual_norm``, and any
                        level-2 ``*_rel_err`` fidelity scalar): climbs to
                        a more expensive rung when the EF bank grows faster
                        than ``control_ef_up`` (compression is eating
                        signal the bank cannot keep absorbing, the
                        arXiv:2305.15264 EF-growth regime), steps to a
                        cheaper rung when the slope falls below
                        ``control_ef_down``. ``control_hysteresis`` rounds
                        pass between switches and the thresholds are
                        distinct, so the loop cannot flap every round.
  * ``staleness_aware`` — closed loop on the buffered-async engine's
                        ``async/staleness_mean`` and ``async/buffer_fill``
                        (asyncfed only): a cheaper rung while cohorts
                        arrive stale, back toward fidelity when they are
                        fresh, and the engine's (K, C) pair moved toward
                        the backlog band through the controller's retune
                        listeners.

Every decision is a pure function of (policy state, round index, drained
telemetry): the controller checkpoints that state, so a resumed run
reproduces the unbroken run's rung sequence bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

CONTROL_POLICIES = ("none", "fixed", "budget_pacing", "ef_feedback",
                    "staleness_aware")

_SCHEDULE_GRAMMAR = (
    'comma-separated "A-B=rung" round ranges (B empty = open-ended, '
    'e.g. "0-99=2,100-199=1,200-=0"); ranges must ascend and not overlap'
)


class BudgetExhaustedError(RuntimeError):
    """The byte budget cannot admit another round even at the cheapest
    rung. Raised BEFORE the offending round dispatches, so the ledger's
    cumulative bytes never exceed the cap."""

    def __init__(self, *, step: int, budget_bytes: int, spent_bytes: int,
                 cheapest_round_bytes: int, rung: int):
        self.step = step
        self.budget_bytes = budget_bytes
        self.spent_bytes = spent_bytes
        self.cheapest_round_bytes = cheapest_round_bytes
        self.rung = rung
        super().__init__(
            f"communication budget exhausted at round {step}: "
            f"{spent_bytes:,} B of the {budget_bytes:,} B budget spent, and "
            f"even the cheapest rung ({rung}) needs "
            f"{cheapest_round_bytes:,} B for the next round. The run "
            f"completed {step} full rounds within budget. Raise --budget_mb, "
            "extend the ladder with a cheaper rung, or treat this as the "
            "honest end of a fixed-budget run.")


def parse_schedule(spec: str) -> Tuple[Tuple[int, Optional[int], int], ...]:
    """``control_schedule`` -> ((start, end_inclusive_or_None, rung), ...).
    The syntax is checked here; the rungs against the ladder's length by
    Config, and the round ranges against the run length by the controller
    (only the train loop knows it)."""

    def fail(why):
        return ValueError(f"bad control_schedule {spec!r}: {why}. Grammar: "
                          f"{_SCHEDULE_GRAMMAR}")

    if not spec or not spec.strip():
        return ()
    out = []
    for raw in spec.split(","):
        part = raw.strip()
        rng_s, sep, rung_s = part.partition("=")
        if not sep:
            raise fail(f"segment {part!r} lacks '=rung'")
        a, sep2, b = rng_s.partition("-")
        try:
            start = int(a)
            end = int(b) if (sep2 and b.strip()) else (start if not sep2
                                                       else None)
            rung = int(rung_s)
        except ValueError:
            raise fail(f"segment {part!r} is not A-B=rung") from None
        if start < 0 or (end is not None and end < start) or rung < 0:
            raise fail(f"segment {part!r} has a negative/descending range "
                       "or rung")
        if out:
            prev_end = out[-1][1]
            if prev_end is None:
                raise fail("an open-ended range must be last")
            if start <= prev_end:
                raise fail(f"range starting at {start} overlaps the "
                           f"previous range ending at {prev_end}")
        out.append((start, end, rung))
    return tuple(out)


class DecisionContext:
    """What a policy sees each round, assembled by the controller."""

    def __init__(self, *, step: int, num_rounds: int, rung: int,
                 num_rungs: int, round_bytes, spent_bytes: int,
                 budget_bytes: Optional[int], last_switch_round: int,
                 hysteresis: int, staleness_mean: Optional[float] = None,
                 effective_participation: Optional[float] = None,
                 buffer_fill: Optional[float] = None,
                 num_workers: Optional[int] = None):
        self.step = step
        self.num_rounds = num_rounds
        self.rung = rung
        self.num_rungs = num_rungs
        # round_bytes(rung) -> this round's ledger bytes at that rung (the
        # live count's under fedsim masking)
        self.round_bytes = round_bytes
        self.spent_bytes = spent_bytes
        self.budget_bytes = budget_bytes
        self.last_switch_round = last_switch_round
        self.hysteresis = hysteresis
        # the buffered-async engine's signals of the update (None on a
        # synchronous round); buffer_fill is the RAW delivered-unconsumed
        # count after the fire, which a policy normalizes by K itself
        self.staleness_mean = staleness_mean
        self.effective_participation = effective_participation
        self.buffer_fill = buffer_fill
        self.num_workers = num_workers


class ControlPolicy:
    """Base policy: never moves."""

    name = "?"
    # float64 slots this policy keeps in the controller's checkpoint blob
    # (beyond the controller's own), loaded back as they are
    STATE_SLOTS = 0
    # True: the policy also moves the buffered-async (K, C) pair
    # (``decide_async``)
    ADAPTS_ASYNC = False

    def __init__(self, cfg):
        self.cfg = cfg

    def initial_rung(self, num_rungs: int) -> int:
        return 0

    def observe(self, step: int, scalars: Dict[str, float]) -> None:
        """Feed one DRAINED round's scalars (step order); a policy that
        reads no telemetry ignores them."""

    def decide(self, ctx: DecisionContext) -> int:
        return ctx.rung

    def state(self) -> tuple:
        return ()

    def load_state(self, slots: tuple) -> None:
        pass


class FixedPolicy(ControlPolicy):
    """Round-range schedule: the rung is a function of the round index
    (``parse_schedule``); a round outside every range runs rung 0."""

    name = "fixed"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.schedule = parse_schedule(cfg.control_schedule)

    def validate_rounds(self, num_rounds: int) -> None:
        for start, end, rung in self.schedule:
            bad = start if start >= num_rounds else (
                end if end is not None and end >= num_rounds else None)
            if bad is not None:
                raise ValueError(
                    f"control_schedule range {start}-"
                    f"{'' if end is None else end}={rung} references round "
                    f"{bad}, but this run has only {num_rounds} rounds "
                    "(steps_per_epoch x num_epochs) — shrink the schedule "
                    "or lengthen the run")

    def rung_at(self, step: int) -> int:
        for start, end, rung in self.schedule:
            if start <= step and (end is None or step <= end):
                return rung
        return 0

    def initial_rung(self, num_rungs: int) -> int:
        return min(self.rung_at(0), num_rungs - 1)

    def decide(self, ctx: DecisionContext) -> int:
        return min(self.rung_at(ctx.step), ctx.num_rungs - 1)


class BudgetPacingPolicy(ControlPolicy):
    """Even pacing against the byte budget: allowance = remaining bytes /
    remaining rounds; the most expensive rung that fits it. The
    controller's hard clamp below it keeps the cap from being crossed."""

    name = "budget_pacing"

    def decide(self, ctx: DecisionContext) -> int:
        remaining = ctx.budget_bytes - ctx.spent_bytes
        allowance = remaining / max(ctx.num_rounds - ctx.step, 1)
        for r in range(ctx.num_rungs):  # rung 0 = most expensive
            if ctx.round_bytes(r) <= allowance:
                return r
        return ctx.num_rungs - 1


class EfFeedbackPolicy(ControlPolicy):
    """Closed loop on the error-feedback telemetry.

    ``observe`` tracks the relative slope of ``diag/ef_residual_norm``
    round over round ((ef_t - ef_{t-1}) / max(ef_{t-1}, eps); drains are
    in step order, so consecutive drained rounds are consecutive rounds)
    and the worst level-2 fidelity scalar (any ``diag/*_rel_err``).
    ``decide`` climbs one rung toward more bytes when the slope exceeds
    ``control_ef_up`` or the fidelity exceeds ``control_fidelity_max`` (>
    0 enables it), steps one rung cheaper when the slope is below
    ``control_ef_down``, and otherwise holds. No decision within
    ``control_hysteresis`` rounds of the last switch, and ``control_ef_up
    > control_ef_down`` (Config checks it), so a signal between the
    thresholds holds. Starts at the CHEAPEST rung: early rounds tolerate
    aggressive compression, and the loop climbs when the telemetry says
    otherwise."""

    name = "ef_feedback"
    STATE_SLOTS = 3  # prev_ef, last_slope, last_fidelity

    def __init__(self, cfg):
        super().__init__(cfg)
        self.prev_ef: Optional[float] = None
        self.last_slope: Optional[float] = None
        self.last_fidelity: Optional[float] = None

    def initial_rung(self, num_rungs: int) -> int:
        return num_rungs - 1

    def observe(self, step: int, scalars: Dict[str, float]) -> None:
        ef = scalars.get("diag/ef_residual_norm")
        if ef is not None and math.isfinite(float(ef)):
            ef = float(ef)
            if self.prev_ef is not None:
                self.last_slope = (ef - self.prev_ef) / max(self.prev_ef,
                                                            1e-30)
            self.prev_ef = ef
        fids = [float(v) for k, v in scalars.items()
                if k.startswith("diag/") and k.endswith("_rel_err")
                and math.isfinite(float(v))]
        if fids:
            self.last_fidelity = max(fids)

    def decide(self, ctx: DecisionContext) -> int:
        if (ctx.last_switch_round >= 0
                and ctx.step - ctx.last_switch_round < ctx.hysteresis):
            return ctx.rung
        cfg = self.cfg
        fid_bad = (cfg.control_fidelity_max > 0
                   and self.last_fidelity is not None
                   and self.last_fidelity > cfg.control_fidelity_max)
        if self.last_slope is None and not fid_bad:
            return ctx.rung  # nothing drained yet
        if fid_bad or (self.last_slope is not None
                       and self.last_slope > cfg.control_ef_up):
            return max(ctx.rung - 1, 0)  # climb: spend more bytes
        if (self.last_slope is not None
                and self.last_slope < cfg.control_ef_down):
            return min(ctx.rung + 1, ctx.num_rungs - 1)  # descend: save
        return ctx.rung

    def state(self) -> tuple:
        nan = float("nan")
        return (nan if self.prev_ef is None else self.prev_ef,
                nan if self.last_slope is None else self.last_slope,
                nan if self.last_fidelity is None else self.last_fidelity)

    def load_state(self, slots: tuple) -> None:
        def opt(v):
            return None if math.isnan(v) else float(v)

        self.prev_ef, self.last_slope, self.last_fidelity = map(opt, slots)


class StalenessAwarePolicy(ControlPolicy):
    """Closed loop on the buffered-async staleness telemetry.

    ``decide`` (the rung walk): ``async/staleness_mean`` above
    ``control_staleness_hi`` means cohorts arrive so late that their
    gradients mostly fight the server's newer params, so one rung cheaper
    a decision; below ``control_staleness_lo`` the fleet keeps up and the
    loop climbs back toward fidelity. ``hi > lo`` (Config checks it) and
    ``control_hysteresis`` hold a signal inside the band.

    ``decide_async`` (the (K, C) retune): a normalized backlog
    ``buffer_fill / K`` above ``control_fill_hi`` grows K (each fire
    absorbs more of the queue); staleness above its band sheds concurrency
    toward 1, then, once the backlog is at or below ``control_fill_lo``,
    shrinks K; a fresh fleet restores concurrency up to the configured
    ``async_concurrency``. One move a decision; the controller clamps the
    pair and applies the retune hysteresis.

    Stateless (``STATE_SLOTS = 0``): each decision is a function of the
    update's ``DecisionContext``, so a resume needs only the controller's
    own (K, C, retunes) slots."""

    name = "staleness_aware"
    ADAPTS_ASYNC = True

    def decide(self, ctx: DecisionContext) -> int:
        if (ctx.last_switch_round >= 0
                and ctx.step - ctx.last_switch_round < ctx.hysteresis):
            return ctx.rung
        stale = ctx.staleness_mean
        if stale is None:
            return ctx.rung  # a synchronous round
        cfg = self.cfg
        if stale > cfg.control_staleness_hi:
            return min(ctx.rung + 1, ctx.num_rungs - 1)  # cheaper
        if stale < cfg.control_staleness_lo:
            return max(ctx.rung - 1, 0)  # back toward fidelity
        return ctx.rung

    def decide_async(self, ctx: DecisionContext, k: int, c: int):
        stale, fill = ctx.staleness_mean, ctx.buffer_fill
        if stale is None or fill is None:
            return k, c
        cfg = self.cfg
        norm = float(fill) / max(k, 1)
        if (norm > cfg.control_fill_hi and ctx.num_workers is not None
                and k < ctx.num_workers):
            return k + 1, c  # backlog over the band: absorb more a fire
        if stale > cfg.control_staleness_hi:
            if c > 1:
                return k, c - 1  # fewer cohorts in flight age less
            if norm <= cfg.control_fill_lo and k > 1:
                return k - 1, c  # starved and stale: smaller buffers
            return k, c
        if stale < cfg.control_staleness_lo and c < cfg.async_concurrency:
            return k, c + 1  # a fresh fleet: the configured concurrency
        return k, c


POLICIES = {p.name: p for p in (FixedPolicy, BudgetPacingPolicy,
                                EfFeedbackPolicy, StalenessAwarePolicy)}


def get_policy(cfg) -> ControlPolicy:
    """The policy of ``cfg.control_policy`` (never "none": the controller's
    construction gate stops that before here)."""
    try:
        cls = POLICIES[cfg.control_policy]
    except KeyError:
        raise ValueError(
            f"unknown control policy {cfg.control_policy!r}; registered: "
            f"{tuple(sorted(POLICIES))}") from None
    return cls(cfg)


def initial_rung_index(cfg, num_rungs: int) -> int:
    """The rung a fresh session starts on, needed at SESSION build (the
    controller comes later, once the train loop knows the run length), so
    a function of the config alone."""
    if cfg.control_policy == "none":
        return 0
    return get_policy(cfg).initial_rung(num_rungs)

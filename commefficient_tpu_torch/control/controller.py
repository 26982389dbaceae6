"""BudgetController — the closed loop that owns the rung dispatch and its
byte accounting (the port's copy of the reference's
``control/controller.py``).

Its place in the round (``FederatedSession._round``):

    env = session.fedsim_env.round_env(step)         # the host masks
    controller.on_round_start(step, env.stats)       # decide, switch
    session.round_fn(...)                            # the ACTIVE rung's

``on_round_start`` runs on the host BEFORE the dispatch: it asks the
policy for the round's rung, clamps the choice against the byte budget
(raising ``BudgetExhaustedError`` before the round that cannot be paid for
ever runs), switches the session's active rung when the decision changed
(a lookup of the round closure built at session build, and a
``Compressor.migrate_state`` pass over the server-state leaves), and
accounts the round's bytes with EXACTLY the CommLedger's arithmetic (the
live count's under fedsim masking), so the controller's budget and the
ledger never disagree.

Telemetry flows the other way at the drain: ``observe_drained`` feeds each
drained round's scalars to the policy (the ``ef_feedback`` loop's input),
and ``scalars()`` puts ``control/rung``, ``control/switches`` and, with a
budget, ``control/budget_remaining_bytes`` on every round's metrics, which
is how the per-rung ledger recovers each drained round's rung.

The controller's state (active rung, switches, bytes spent, the policy's
slots) is a small float64 blob carried in checkpoints
(``utils/checkpoint.py``): decisions are functions of (blob, round index,
drained telemetry), and drains happen before saves, so a resumed run
reproduces the unbroken run's rung sequence bit for bit. The blob keeps
the reference's layout (version 3: 13 fixed fields, then the policy's
slots); its field 8 is the elastic fleet's width at the capture (-1 for a
run with no fleet event), advisory: a restore re-derives the width from
the schedule (``FederatedSession.sync_round_clock``). Under the fleet a
round is accounted at its realized width (``fleet/width``), as the ledger
bills it, and a rung switch inside a resize window dispatches the new
rung's closure for that width.

Under the buffered-async engine (asyncfed/) the decision point is the
engine's, once an update before its apply, and ``fs_stats`` carries the
update's ``async/*`` scalars: a policy with ``ADAPTS_ASYNC``
(``staleness_aware``) also moves the engine's (K, C) pair
(``_maybe_retune``), which the engine's retune listener picks up, and
``scalars()`` then adds ``control/async_k``, ``control/async_c`` and
``control/retunes``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from commefficient_tpu_torch.control.policy import (
    BudgetExhaustedError,
    DecisionContext,
    FixedPolicy,
    get_policy,
)

_BLOB_VERSION = 3
# blob layout: [version, rung, switches, rounds_seen, spent_up, spent_down,
#               last_switch_round, min_rung, fleet_width, async_k, async_c,
#               retunes, last_retune_round, *policy slots]; float64 holds
# every field exactly (byte counts stay far below 2^53)
_BLOB_FIXED = 13


class BudgetController:
    """One per session when ``cfg.control_policy != 'none'``."""

    def __init__(self, cfg, session, num_rounds: int):
        self.cfg = cfg
        self.session = session
        self.num_rounds = int(num_rounds)
        self.policy = get_policy(cfg)
        if isinstance(self.policy, FixedPolicy):
            # the schedule's rounds against the run length, which only the
            # train loop knows (as the chaos plan's rounds)
            self.policy.validate_rounds(self.num_rounds)
        self.num_rungs = len(session.rungs)
        self.budget_bytes: Optional[int] = (
            int(cfg.budget_mb * 1_000_000) if cfg.budget_mb > 0 else None)
        self.masked = bool(cfg.fedsim_enabled)
        self._bytes = [session.rung_bytes_per_round(i)
                       for i in range(self.num_rungs)]
        self._comps = [r.compressor for r in session.rungs]
        self.switches = 0
        self.rounds_seen = 0
        self.spent_up = 0
        self.spent_down = 0
        self.last_switch_round = -1
        # the demotion floor of a resilience recovery: rungs below it are
        # off limits to every decision, and it rides the blob
        self.min_rung = 0
        # rung-switch observers (the pipelined engine registers one),
        # called after the switch and its migration and before the round
        # dispatches. The staged inputs of later rounds do not depend on
        # the rung (batch, fedsim masks, lr), so a switch invalidates
        # nothing in flight
        self._switch_listeners = []
        # the buffered-async (K, C) pair: the controller owns the live
        # one (the engine's retune listener follows it); only an
        # ADAPTS_ASYNC policy moves it
        self.async_k = int(cfg.async_buffer)
        self.async_c = int(cfg.async_concurrency)
        self.retunes = 0
        self.last_retune_round = -1
        self._retune_listeners = []
        session.controller = self

    def add_switch_listener(self, fn) -> None:
        """Register ``fn(step, old_rung, new_rung)``, called at each rung
        switch. A listener only observes: raising aborts the round the
        switch serves."""
        self._switch_listeners.append(fn)

    def add_retune_listener(self, fn) -> None:
        """Register ``fn(step, k, c)``, called when an ADAPTS_ASYNC policy
        moves the buffered-async (K, C) pair (the engine rebuilds its
        schedule), and again by ``load_state_blob`` with the restored
        pair. A listener only observes."""
        self._retune_listeners.append(fn)

    # -- byte accounting (telemetry.CommLedger's arithmetic) ---------------
    def _live_avail(self, fs_stats: Optional[Dict[str, float]]):
        s = fs_stats or {}
        # an elastic fleet's round at its realized width (the fedsim rates
        # are relative to it): CommLedger._counts' arithmetic
        W = int(round(float(s.get("fleet/width", self.cfg.num_workers))))
        rate = s.get("fedsim/participation_rate")
        live = W if rate is None else int(round(float(rate) * W))
        avail = W - int(round(float(s.get("fedsim/dropped", 0.0))))
        return live, avail

    def _up_down(self, rung: int, live: int, avail: int):
        """(uplink, downlink) ledger bytes of one round at ``rung`` for the
        realized participation: the arithmetic ``CommLedger.on_round``
        applies, through the same ``masked_upload_floats`` hook."""
        bpr = self._bytes[rung]
        if not self.masked:
            return bpr["upload_bytes"], bpr["download_bytes"]
        comp = self._comps[rung]
        up = comp.upload_bytes_per_float() * comp.masked_upload_floats(live)
        return up, avail * bpr["download_bytes"]

    def round_bytes(self, rung: int, live: int, avail: int) -> int:
        """One round's ledger bytes at ``rung`` (``_up_down``'s sum)."""
        return sum(int(b) for b in self._up_down(rung, live, avail))

    @property
    def spent_bytes(self) -> int:
        return self.spent_up + self.spent_down

    # -- the decision of a round --------------------------------------------
    def on_round_start(self, step: int,
                       fs_stats: Optional[Dict[str, float]] = None) -> int:
        """Pick, and switch to, the rung round ``step`` dispatches at;
        returns it. Raises ``BudgetExhaustedError`` when even the cheapest
        rung would overshoot the budget, BEFORE the round runs."""
        live, avail = self._live_avail(fs_stats)
        rung = self.session.active_rung
        s = fs_stats or {}
        # the buffered-async engine's signals (None on synchronous rounds)

        def opt(key):
            return None if s.get(key) is None else float(s[key])

        ctx = DecisionContext(
            step=step, num_rounds=self.num_rounds, rung=rung,
            num_rungs=self.num_rungs,
            round_bytes=lambda r: self.round_bytes(r, live, avail),
            spent_bytes=self.spent_bytes, budget_bytes=self.budget_bytes,
            last_switch_round=self.last_switch_round,
            hysteresis=self.cfg.control_hysteresis,
            staleness_mean=opt("async/staleness_mean"),
            effective_participation=opt("async/effective_participation"),
            buffer_fill=opt("async/buffer_fill"),
            num_workers=self.cfg.num_workers)
        target = self.policy.decide(ctx)
        target = min(max(int(target), 0), self.num_rungs - 1)
        # the demotion floor (a higher index is a cheaper rung)
        target = max(target, self.min_rung)
        if self.budget_bytes is not None:
            # the hard clamp, whatever the policy: the most expensive rung
            # that still fits the budget; none fits -> stop before
            # dispatching a round the cap cannot pay for
            while (target < self.num_rungs
                   and self.spent_bytes + self.round_bytes(
                       target, live, avail) > self.budget_bytes):
                target += 1
            if target >= self.num_rungs:
                cheapest = self.num_rungs - 1
                raise BudgetExhaustedError(
                    step=step, budget_bytes=self.budget_bytes,
                    spent_bytes=self.spent_bytes,
                    cheapest_round_bytes=self.round_bytes(cheapest, live,
                                                          avail),
                    rung=cheapest)
        if target != rung:
            self.session.set_active_rung(target, migrate=True)
            self.switches += 1
            self.last_switch_round = step
            for fn in self._switch_listeners:
                fn(step, rung, target)
        if self.policy.ADAPTS_ASYNC:
            self._maybe_retune(step, ctx)
        up, down = self._up_down(target, live, avail)
        self.spent_up += int(up)
        self.spent_down += int(down)
        self.rounds_seen += 1
        return target

    def _maybe_retune(self, step: int, ctx: DecisionContext) -> None:
        """Ask the ADAPTS_ASYNC policy for the next (K, C) pair, clamp it
        to the engine's range (1 <= K <= W, C >= 1) and notify the retune
        listeners of a change. No retune within ``control_hysteresis``
        rounds of the last one, so the schedule's rebuild cannot
        thrash."""
        if (self.last_retune_round >= 0
                and step - self.last_retune_round
                < self.cfg.control_hysteresis):
            return
        k, c = self.policy.decide_async(ctx, self.async_k, self.async_c)
        k = min(max(int(k), 1), int(self.cfg.num_workers))
        c = max(int(c), 1)
        if (k, c) == (self.async_k, self.async_c):
            return
        self.async_k, self.async_c = k, c
        self.retunes += 1
        self.last_retune_round = step
        for fn in self._retune_listeners:
            fn(step, k, c)

    def demote(self, step: int) -> int:
        """A recovery's demotion (the reference's resilience ``demote``
        policy): floor the ladder one rung cheaper than the current
        effective rung and switch to it now, through the same
        ``set_active_rung`` and ``migrate_state`` as a policy switch.
        Returns the new active rung (the old one when already at the
        cheapest rung: nothing changes, and the caller treats the demotion
        as unavailable)."""
        old = self.session.active_rung
        # descend from the active rung clamped to the floor: a rollback
        # may re-activate a rung above the floor from an older blob, but
        # every on_round_start clamps back to it
        effective = max(old, self.min_rung)
        target = min(effective + 1, self.num_rungs - 1)
        if target == effective:
            return old
        self.min_rung = max(self.min_rung, target)
        self.session.set_active_rung(target, migrate=True)
        self.switches += 1
        self.last_switch_round = int(step)
        for fn in self._switch_listeners:
            fn(int(step), old, target)
        return target

    # -- telemetry ------------------------------------------------------------
    def scalars(self) -> Dict[str, float]:
        """Host scalars on THIS round's metrics, the same keys every round
        (``pack_metric_dicts`` requires it): ``control/rung`` is the rung
        the round ran at, the per-rung ledger's source;
        ``control/budget_remaining_bytes`` is what is left after this
        round's spend, present only with a budget; ``control/async_k``,
        ``control/async_c`` and ``control/retunes`` only under an
        ADAPTS_ASYNC policy."""
        out = {"control/rung": float(self.session.active_rung),
               "control/switches": float(self.switches)}
        if self.budget_bytes is not None:
            out["control/budget_remaining_bytes"] = float(
                self.budget_bytes - self.spent_bytes)
        if self.policy.ADAPTS_ASYNC:
            out["control/async_k"] = float(self.async_k)
            out["control/async_c"] = float(self.async_c)
            out["control/retunes"] = float(self.retunes)
        return out

    def observe_drained(self, step: int, scalars: Dict[str, float]) -> None:
        """The drain's rider (``utils.logging.drain_round_metrics``): one
        drained round's scalars to the policy, in step order."""
        self.policy.observe(step, scalars)

    def snapshot(self) -> dict:
        """The controller block of the flight dumps: enough to tie a
        divergence to a rung switch."""
        out = {"policy": self.cfg.control_policy,
               "ladder": self.cfg.ladder,
               "rung": int(self.session.active_rung),
               "num_rungs": self.num_rungs,
               "switches": int(self.switches),
               "rounds_seen": int(self.rounds_seen),
               "last_switch_round": int(self.last_switch_round)}
        if self.budget_bytes is not None:
            out["budget_bytes"] = int(self.budget_bytes)
            out["budget_remaining_bytes"] = int(self.budget_bytes
                                                - self.spent_bytes)
        if self.cfg.fleet_enabled:
            out["fleet_width"] = int(self.session._fleet_width)
        return out

    def describe(self) -> str:
        bits = [f"policy={self.cfg.control_policy}",
                f"rungs={self.num_rungs}",
                f"start_rung={self.session.active_rung}"]
        if self.budget_bytes is not None:
            bits.append(f"budget={self.budget_bytes / 1e6:g} MB")
        return "control: " + " ".join(bits)

    def prewarm(self) -> int:
        """Make every rung ready to dispatch before the first round: the
        rungs' round closures and CountSketch specs exist since the
        session's build, and ``FederatedSession.prewarm_rungs`` builds the
        kernels' host plans of every rung's spec on the card, so a switch
        builds no plan. Runs no round and changes no state; returns the
        number of rungs. (The reference's prewarm compiles each rung's
        round ahead of time; the port compiles no round.)"""
        return self.session.prewarm_rungs()

    # -- checkpoint state -----------------------------------------------------
    def state_blob(self) -> np.ndarray:
        # the fleet width at the capture (advisory, see load_state_blob);
        # -1 tells "no fleet" from "the fleet at its base width"
        fleet_w = (int(self.session._fleet_width) if self.cfg.fleet_enabled
                   else -1)
        return np.asarray(
            [_BLOB_VERSION, self.session.active_rung, self.switches,
             self.rounds_seen, self.spent_up, self.spent_down,
             self.last_switch_round, self.min_rung, fleet_w,
             self.async_k, self.async_c, self.retunes,
             self.last_retune_round, *self.policy.state()], np.float64)

    def load_state_blob(self, blob) -> None:
        blob = np.asarray(blob, np.float64)
        version = int(blob[0])
        if version != _BLOB_VERSION:
            raise ValueError(
                f"controller checkpoint blob version {version} != "
                f"{_BLOB_VERSION} — checkpoint from an incompatible build")
        want = _BLOB_FIXED + self.policy.STATE_SLOTS
        if blob.shape != (want,):
            raise ValueError(
                f"controller checkpoint blob has shape {blob.shape}, "
                f"expected ({want},) for policy "
                f"{self.cfg.control_policy!r} — the checkpoint was written "
                "under a different control config")
        rung = int(blob[1])
        if not 0 <= rung < self.num_rungs:
            raise ValueError(
                f"controller checkpoint names rung {rung}, but this "
                f"session's ladder has {self.num_rungs} rung(s) — restore "
                "with the ladder the checkpoint was written under")
        # the restored leaves are ALREADY in the saved rung's layout (the
        # checkpoint's template was that rung's): switch the dispatch only
        self.session.set_active_rung(rung, migrate=False)
        self.switches = int(blob[2])
        self.rounds_seen = int(blob[3])
        self.spent_up = int(blob[4])
        self.spent_down = int(blob[5])
        self.last_switch_round = int(blob[6])
        # monotone: a rollback to an older blob keeps a floor raised since
        self.min_rung = max(self.min_rung, int(blob[7]))
        # blob[8], the fleet width at the capture, is advisory: every
        # restore path re-derives the width from the schedule
        # (sync_round_clock), and a stale width must not override it
        self.async_k = int(blob[9])
        self.async_c = int(blob[10])
        self.retunes = int(blob[11])
        self.last_retune_round = int(blob[12])
        # the engine follows the restored pair (its listener ignores the
        # pair it already runs)
        for fn in self._retune_listeners:
            fn(self.last_retune_round, self.async_k, self.async_c)
        self.policy.load_state(tuple(blob[_BLOB_FIXED:]))


def build_controller(cfg, session, num_rounds: int) -> Optional[
        BudgetController]:
    """The one construction gate (as ``fedsim.build_environment``): a
    controller iff the config turns the control plane on; None keeps every
    caller on the path it ran before."""
    if not getattr(cfg, "control_enabled", False):
        return None
    return BudgetController(cfg, session, num_rounds)


def controller_header(session) -> dict:
    """The run header's controller block, available at SESSION build
    (before the controller exists: the metrics writer writes its header
    at construction): the initial rung and the ladder's identity. ``{}``
    for a session without the control plane."""
    rungs = getattr(session, "rungs", None)
    if rungs is None or not getattr(session.cfg, "control_enabled", False):
        return {}
    return {"controller": {"policy": session.cfg.control_policy,
                           "ladder": session.cfg.ladder,
                           "rung": int(session.active_rung),
                           "num_rungs": len(rungs)}}

"""Buffered-asynchronous federation schedule — the host-side event clock
(the port's copy of ``commefficient_tpu/asyncfed/schedule.py``; numpy
only, and equal to it for the same arguments).

The asyncfed engine (asyncfed/engine.py) keeps ``C`` client cohorts in
flight and fires a server update whenever ``K`` of the in-flight
contributions have arrived (buffered asynchronous aggregation, FedBuff —
arXiv:2106.06639 — layered on FetchSGD's stateless-client compression).
Devices never see wall time: this module pre-simulates the run's whole
arrival process into a deterministic sequence of ``UpdateSpec``s — which
cohorts launch before each update, which ``(cohort, slot)`` contributions
the update consumes, and each contribution's staleness — as a pure
function of ``(seed, arrival_rate, num_workers, K, C)``. Everything
downstream (engine dispatch, the staleness discount, telemetry, the
resilience vault replay) keys off this sequence, so an asyncfed run is
exactly as reproducible and resumable as a synchronous one.

Per-slot arrival delays are exponential with rate ``cfg.arrival_rate`` —
the same process the synchronous ``availability='poisson'`` model
projects to round granularity (fedsim/availability.py) — drawn from a
dedicated rng stream (``ASYNC_STREAM``, one generator per cohort) so
overlapping cohorts' arrivals interleave in continuous time without
perturbing the fedsim masks or the sampler's batch draws.

Semantics pinned here (tests/test_torch_asyncfed.py holds the port's
schedule equal to the reference's):

* **Staleness** is the server-version delta between a contribution's
  launch snapshot and the update that consumes it:
  ``s = fire_version - launch_version[cohort]``.
* **Consumption order**: an update consumes the K OLDEST arrivals, but
  lists them in canonical ``(cohort, slot)`` order — a sum over
  permuted rows changes f32 rounding, so the canonical order makes the
  aggregate a function of the consumed SET (arrival-order independent)
  and makes the K=W, C=1 anchor's slot order exactly ``0..W-1``, i.e.
  the synchronous round's reduction order (bit-identity).
* **In flight** means launched and not yet fully DELIVERED. A cohort
  whose arrivals are all buffered but unconsumed is done transmitting —
  counting it in flight would deadlock K < W at C=1 (W=8, K=5: the
  cohort delivers 8, the fire consumes 5, 3 stay buffered; the relaunch
  must not wait on them).
* **Fire before top-up**: the update fires at the triggering arrival,
  THEN fresh cohorts launch against the post-update version — so at
  C=1, K=W cohort ``u+1`` launches at version ``u+1`` and every
  contribution's staleness is 0 (the synchronous anchor).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

# distinct rng stream tag: (seed, ASYNC_STREAM, cohort) can never collide
# with the sampler's (seed, round) or fedsim's (seed, FEDSIM_STREAM, round)
ASYNC_STREAM = 0xA5F3D


class UpdateSpec(NamedTuple):
    """One server update's realized schedule."""

    index: int  # update index == the server version it produces - 1
    slots: Tuple[Tuple[int, int], ...]  # K consumed (cohort, slot), sorted
    staleness: Tuple[int, ...]  # per consumed slot, aligned with ``slots``
    launches_before: Tuple[int, ...]  # cohorts to launch before assembling
    buffer_fill_after: int  # delivered-unconsumed contributions post-fire
    concurrent_after: int  # cohorts in flight after the post-fire top-up


def cohort_delays(seed: int, cohort: int, num_workers: int,
                  rate: float) -> np.ndarray:
    """One cohort's per-slot arrival delays (round-deadline units) —
    deterministic from ``(seed, cohort)`` alone. Unit exponentials scaled
    after the fact so ``rate=inf`` (every delay exactly 0 — the degenerate
    synchronous limit) draws through the same rng cursor."""
    rng = np.random.default_rng((seed, ASYNC_STREAM, cohort))
    scale = 0.0 if np.isinf(rate) else 1.0 / rate
    return rng.exponential(1.0, num_workers) * scale


class AsyncSchedule:
    """The pre-simulated run: ``updates[u]`` scripts update ``u``.

    ``launch_version[c]`` is the server version cohort ``c`` snapshots at
    launch; ``num_cohorts`` counts only cohorts some update actually
    launches (trailing simulated top-ups past the last fire are dropped —
    the engine never runs them)."""

    def __init__(self, *, seed: int, num_workers: int, buffer_k: int,
                 concurrency: int, arrival_rate: float, num_updates: int):
        W = int(num_workers)
        K = int(buffer_k)
        C = int(concurrency)
        if not 1 <= K <= W:
            raise ValueError(f"buffer_k must be in [1, num_workers]; got {K}")
        if C < 1:
            raise ValueError(f"concurrency must be >= 1; got {C}")
        self.seed = int(seed)
        self.num_workers = W
        self.buffer_k = K
        self.concurrency = C
        self.arrival_rate = float(arrival_rate)

        heap: List[Tuple[float, int, int]] = []  # (arrival, cohort, slot)
        launch_version: List[int] = []
        pending_launch: List[int] = []
        undelivered: Dict[int, int] = {}
        buffer: List[Tuple[int, int]] = []  # delivered-unconsumed, FIFO
        updates: List[UpdateSpec] = []
        version = 0
        now = 0.0

        def launch():
            c = len(launch_version)
            launch_version.append(version)
            delays = cohort_delays(self.seed, c, W, self.arrival_rate)
            for s in range(W):
                # ties (rate=inf: every delay 0) break by (cohort, slot)
                # tuple order — deterministic, launch-order arrivals
                heapq.heappush(heap, (now + float(delays[s]), c, s))
            undelivered[c] = W
            pending_launch.append(c)

        for _ in range(C):
            launch()
        while len(updates) < int(num_updates):
            if not heap:  # pragma: no cover — every launched slot arrives
                raise AssertionError("asyncfed schedule: event heap drained "
                                     "with updates still owed")
            now, c, s = heapq.heappop(heap)
            undelivered[c] -= 1
            if undelivered[c] == 0:
                del undelivered[c]  # fully delivered -> no longer in flight
            buffer.append((c, s))
            fired = None
            if len(buffer) >= K:
                oldest = buffer[:K]
                del buffer[:K]
                consumed = tuple(sorted(oldest))  # canonical (cohort, slot)
                fired = UpdateSpec(
                    index=len(updates),
                    slots=consumed,
                    staleness=tuple(version - launch_version[cc]
                                    for cc, _ in consumed),
                    launches_before=tuple(pending_launch),
                    buffer_fill_after=len(buffer),
                    concurrent_after=0,  # backfilled after the top-up
                )
                pending_launch.clear()
                version += 1
            # top-up AFTER the fire so fresh cohorts snapshot the updated
            # params; skipped once the run's updates are all scripted (the
            # engine would never launch them)
            while (len(undelivered) < C
                   and len(updates) + (1 if fired else 0) < int(num_updates)):
                launch()
            if fired is not None:
                updates.append(
                    fired._replace(concurrent_after=len(undelivered))
                )

        self.updates: Tuple[UpdateSpec, ...] = tuple(updates)
        self.launch_version: Tuple[int, ...] = tuple(launch_version)
        # only cohorts some update launches exist to the engine; launches
        # are assigned in cohort-index order, so this is a prefix count
        self.num_cohorts = sum(len(u.launches_before) for u in updates)

    def launched_before(self, update: int) -> int:
        """Cohorts launched before update ``update`` assembles — the
        engine's cold-restart window derivation."""
        return sum(len(self.updates[u].launches_before)
                   for u in range(update))

"""FedEnvironment — availability + chaos composed into per-round masks (the
reference's ``fedsim/env.py`` without the elastic-fleet width schedule,
which is ROADMAP A11).

One ``RoundEnv`` per round: what the masked round consumes (live mask,
corruption mask, live count) plus the host-side ``fedsim/*`` scalars that
ride the round's metrics. Masks are numpy, drawn on the host; the round
applies them on the device.

``FederatedSession`` owns one environment (``build_environment(cfg)`` —
None when ``cfg.fedsim_enabled`` is False) and realizes round
``state.step``'s environment, so a resumed run (the step restored from a
checkpoint) realizes exactly the masks the unbroken run realized: every
mask is a pure function of ``(seed, round_idx)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from commefficient_tpu_torch.fedsim.availability import (
    round_rng,
    sample_availability,
)
from commefficient_tpu_torch.fedsim.faults import (
    ChaosEvent,
    apply_chaos,
    parse_chaos,
    validate_chaos_rounds,
)


class RoundEnv(NamedTuple):
    """One round's realized environment.

    ``live``/``corrupt`` are float32 ``[num_workers]`` 0/1 masks;
    ``live_count`` the scalar the server renormalizes by; ``stats`` the
    host-side ``fedsim/*`` scalars (a constant key set)."""

    live: np.ndarray
    corrupt: np.ndarray
    live_count: np.float32
    stats: dict


class FedEnvironment:
    """The run-long simulator: availability model + parsed chaos plan."""

    def __init__(self, cfg):
        # duck-typed cfg: this package never imports the config module
        self.num_workers = int(cfg.num_workers)
        self.seed = int(cfg.seed)
        self.availability = cfg.availability
        self.dropout_prob = float(cfg.dropout_prob)
        self.period = int(cfg.availability_period)
        self.num_cohorts = int(cfg.num_cohorts)
        self.arrival_rate = float(cfg.arrival_rate)
        self.plan: Tuple[ChaosEvent, ...] = parse_chaos(cfg.chaos)

    def describe(self) -> str:
        bits = [f"availability={self.availability}"]
        if self.dropout_prob:
            bits.append(f"dropout_prob={self.dropout_prob:g}")
        if self.plan:
            bits.append(f"chaos={len(self.plan)} event(s)")
        return "fedsim: " + " ".join(bits)

    def validate_rounds(self, num_rounds: int) -> None:
        """Reject chaos events referencing rounds the run never reaches —
        callable only where the run length is known (the train entries)."""
        validate_chaos_rounds(self.plan, num_rounds)

    def round_env(self, round_idx: int, replay: bool = False) -> RoundEnv:
        """Realize round ``round_idx``'s masks and ``fedsim/*`` scalars —
        deterministic from ``(seed, round_idx)``, pure (a fresh rng per
        call). ``replay=True`` suppresses the nan_client injection and
        leaves every other draw as it was (``faults.apply_chaos``)."""
        W = self.num_workers
        rng = round_rng(self.seed, round_idx)
        avail = sample_availability(
            self.availability, rng, round_idx,
            num_workers=W, dropout_prob=self.dropout_prob,
            period=self.period, num_cohorts=self.num_cohorts,
            rate=self.arrival_rate,
        )
        avail, straggler, corrupt = apply_chaos(
            self.plan, rng, round_idx, avail, replay=replay
        )
        live = avail & ~straggler
        n_live = int(live.sum())
        stats = {
            "fedsim/participation_rate": n_live / W,
            "fedsim/dropped": float(W - int(avail.sum())),
            "fedsim/straggler_excluded": float(int((avail & straggler).sum())),
            "fedsim/all_dropped": float(n_live == 0),
        }
        return RoundEnv(
            live=live.astype(np.float32),
            corrupt=corrupt.astype(np.float32),
            live_count=np.float32(n_live),
            stats=stats,
        )


def build_environment(cfg) -> Optional[FedEnvironment]:
    """An environment iff the config turns any masking/chaos source on;
    None keeps the round unmasked (nothing fedsim runs)."""
    if not cfg.fedsim_enabled:
        return None
    return FedEnvironment(cfg)

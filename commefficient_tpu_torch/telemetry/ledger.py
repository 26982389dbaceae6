"""The communication ledger (the port's copy of the reference's
``telemetry/ledger.py``): loss against BYTES, FetchSGD's x-axis.

Each drained round is billed at the compressor's ``bytes_per_round``
(the session's, the numbers its entry points print at start), per
participating client: the per-round ``comm/*`` scalars ride the drain,
and ``comm_ledger.json`` sums the run. Counts are exact ints: after R
drained rounds ``cum_up_bytes == R * bytes_per_round["upload_bytes"]``,
the invariant the reference's ``scripts/check_telemetry_schema.py``
enforces. A resumed run counts the rounds its own process drained.

Under fedsim (``masked=True``) only live clients upload and every
available client downloads: the round's uplink is the compressor's
``masked_upload_floats(live)`` times its ``upload_bytes_per_float()``,
its downlink ``avail * download_bytes``, the live and available counts
recovered from the round's own ``fedsim/*`` scalars; the invariant
becomes ``cum_up_bytes == live_client_rounds * upload_bytes``. An elastic
fleet's round counts its clients at the round's realized width (its
``fleet/width`` scalar), not at ``num_workers``.

A run of the control plane's compression ladder (``rungs``: each rung's
``bytes_per_round`` and compressor) bills each drained round at the rung
its own ``control/rung`` scalar names, and keeps per rung its rounds and,
masked, its live and available client-rounds: the invariant becomes the
sum over rungs of each rung's rounds (or live client-rounds) times its
bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch


def run_metadata(cfg=None, extra: Optional[dict] = None) -> dict:
    """The run's identity block, shared by the metrics.jsonl header, the
    flight records and the ledger: wall-clock start, torch and device
    identity (``device_kind`` the card's name or ``"cpu"``, ``backend``
    ``"cuda"`` or ``"cpu"``, as ``cfg.device`` runs), and the config."""
    meta: dict = {"time": time.time(),
                  "start_time": time.strftime("%Y-%m-%dT%H:%M:%S%z")}
    on_card = (getattr(cfg, "device", "cuda") == "cuda"
               and torch.cuda.is_available())
    meta["torch_version"] = torch.__version__
    meta["backend"] = "cuda" if on_card else "cpu"
    meta["device_kind"] = torch.cuda.get_device_name(0) if on_card else "cpu"
    meta["device_count"] = torch.cuda.device_count() if on_card else 1
    if cfg is not None:
        meta["config"] = (dataclasses.asdict(cfg)
                          if dataclasses.is_dataclass(cfg)
                          else {k: v for k, v in vars(cfg).items()
                                if not k.startswith("_")})
    if extra:
        meta.update(extra)
    return meta


# the per-rung counters of a ladder run
_RUNG_COUNTS = ("rounds", "live_client_rounds", "avail_client_rounds")


class CommLedger:
    """Exact uplink and downlink byte counts over the drained rounds.

    ``on_round(step, scalars)`` bills one drained round (drain order is
    step order) and returns its ``comm/*`` scalars; ``write`` persists the
    summary. ``compressor`` (duck-typed: ``masked_upload_floats(live)``,
    ``upload_bytes_per_float()``) prices a masked round's uplink."""

    def __init__(self, bytes_per_round: Dict[str, int], *, mode: str,
                 num_workers: int, masked: bool = False, compressor=None,
                 rungs=None):
        self.bytes_per_round = {k: int(v) for k, v in bytes_per_round.items()}
        self.mode = mode
        self.num_workers = int(num_workers)
        self.masked = bool(masked)
        self._comp = compressor
        # the ladder's [(bytes_per_round, compressor), ...] in rung order,
        # or None for one rung
        self.rungs = None
        if rungs is not None:
            self.rungs = [
                {"bytes_per_round": {k: int(v) for k, v in bpr.items()},
                 "compressor": comp, "rounds": 0,
                 "live_client_rounds": 0, "avail_client_rounds": 0}
                for bpr, comp in rungs]
        self.rounds = 0
        self.cum_up_bytes = 0
        self.cum_down_bytes = 0
        self.live_client_rounds = 0
        self.avail_client_rounds = 0

    def _counts(self, scalars: Optional[Dict[str, float]]):
        """(live, available) clients of one drained round from its
        ``fedsim/*`` scalars (``live/W`` round-trips f32 exactly enough to
        re-round); missing scalars mean full participation. An elastic
        fleet's round bills at its realized width (``fleet/width``, beside
        them: the fedsim rates are relative to it)."""
        scalars = scalars or {}
        W = int(round(float(scalars.get("fleet/width", self.num_workers))))
        rate = scalars.get("fedsim/participation_rate")
        live = W if rate is None else int(round(float(rate) * W))
        avail = W - int(round(float(scalars.get("fedsim/dropped", 0.0))))
        return live, avail

    def on_round(self, step: int,
                 scalars: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
        """Bill one drained round (``scalars``: its drained metrics, where
        the ``fedsim/*`` counts and, on a ladder, ``control/rung`` ride);
        returns its ``comm/*`` scalars."""
        rung_rec = None
        bpr, comp = self.bytes_per_round, self._comp
        if self.rungs is not None:
            r = int(round(float((scalars or {}).get("control/rung", 0.0))))
            if not 0 <= r < len(self.rungs):
                raise ValueError(
                    f"drained round {step} names rung {r}, but the ledger "
                    f"was built for {len(self.rungs)} rung(s)")
            rung_rec = self.rungs[r]
            bpr, comp = rung_rec["bytes_per_round"], rung_rec["compressor"]
        up = bpr["upload_bytes"]
        down = bpr["download_bytes"]
        if self.masked:
            live, avail = self._counts(scalars)
            up = (comp.upload_bytes_per_float()
                  * comp.masked_upload_floats(live)
                  if comp is not None else live * up)
            down = avail * down
            self.live_client_rounds += live
            self.avail_client_rounds += avail
            if rung_rec is not None:
                rung_rec["live_client_rounds"] += live
                rung_rec["avail_client_rounds"] += avail
        if rung_rec is not None:
            rung_rec["rounds"] += 1
        self.rounds += 1
        self.cum_up_bytes += up
        self.cum_down_bytes += down
        return {
            "comm/up_bytes": up,
            "comm/down_bytes": down,
            "comm/cum_up_bytes": self.cum_up_bytes,
            "comm/cum_down_bytes": self.cum_down_bytes,
            "comm/cum_bytes": self.cum_up_bytes + self.cum_down_bytes,
        }

    def snapshot_state(self) -> dict:
        """The mutable counters, host ints: what a rollback rewinds so
        replayed rounds bill once."""
        out = {"rounds": self.rounds,
               "cum_up_bytes": self.cum_up_bytes,
               "cum_down_bytes": self.cum_down_bytes,
               "live_client_rounds": self.live_client_rounds,
               "avail_client_rounds": self.avail_client_rounds}
        if self.rungs is not None:
            out["rungs"] = [{k: r[k] for k in _RUNG_COUNTS}
                            for r in self.rungs]
        return out

    def load_snapshot_state(self, state: dict) -> None:
        """Rewind to a ``snapshot_state`` capture."""
        self.rounds = int(state["rounds"])
        self.cum_up_bytes = int(state["cum_up_bytes"])
        self.cum_down_bytes = int(state["cum_down_bytes"])
        self.live_client_rounds = int(state["live_client_rounds"])
        self.avail_client_rounds = int(state["avail_client_rounds"])
        if self.rungs is not None:
            saved = state.get("rungs")
            if saved is None or len(saved) != len(self.rungs):
                raise ValueError(
                    "ledger snapshot rung count does not match this "
                    "ledger's ladder — the snapshot was captured under a "
                    "different control config")
            for rec, snap in zip(self.rungs, saved):
                for k in _RUNG_COUNTS:
                    rec[k] = int(snap[k])

    def summary(self) -> dict:
        from commefficient_tpu_torch.telemetry import SCHEMA_VERSION

        out = {
            "schema_version": SCHEMA_VERSION,
            "mode": self.mode,
            "num_workers": self.num_workers,
            "bytes_per_round": self.bytes_per_round,
            "rounds": self.rounds,
            "cum_up_bytes": self.cum_up_bytes,
            "cum_down_bytes": self.cum_down_bytes,
            "cum_bytes": self.cum_up_bytes + self.cum_down_bytes,
        }
        if self.masked:
            # cum_up_bytes == live_client_rounds * upload_bytes,
            # cum_down_bytes == avail_client_rounds * download_bytes
            out["live_client_rounds"] = self.live_client_rounds
            out["avail_client_rounds"] = self.avail_client_rounds
        if self.rungs is not None:
            # cum_up_bytes == sum over rungs of rounds * upload_bytes (or,
            # masked, live_client_rounds * upload_bytes); the downlink alike
            out["rungs"] = [
                {k: v for k, v in r.items() if k != "compressor"
                 and (self.masked or not k.endswith("_client_rounds"))}
                for r in self.rungs]
        return out

    def write(self, logdir: str) -> str:
        """Write ``comm_ledger.json`` into the run dir; returns its path."""
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, "comm_ledger.json")
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
        return path

"""The comparison that decides ``correct``.

The reference (``benchmark/reference/``) follows a cell's first rounds
from the same initial weights on the same batches, in float32 with TF32
off. Three numbers are compared, each against its own limit from the
cell's traffic file:

* ``loss_gap``: the largest relative gap between a round's loss and the
  reference's, over the checked rounds;
* ``state_gap``: the optimizer's momentum after ``state_after`` rounds
  (the first gradient as the optimizer gets it, where that is one
  round), leaf by leaf: the gap between the two norms of a leaf, over
  the larger of the reference's norm of that leaf and of the median
  leaf, worst leaf. A sketched momentum is decoded leaf by leaf with the
  reference's own estimate;
* ``delta_gap``: the parameters' change over the checked rounds, leaf
  by leaf as above, over the larger of the reference's change of that
  leaf and the median change of the leaves the reference moves. Leaves
  whose reference momentum norm is under a thousandth of the median
  leaf's are left out (their change is round-off).

The program's readings are what is judged; the reference reads them
only to judge them."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import countsketch, precision, round as ref_round
from benchmark.reference.sampler import round_batch
from benchmark.yardstick import weights
from benchmark.yardstick.layout import leaves, offsets

NUMBERS = ("loss_gap", "state_gap", "delta_gap")
SMALL_LEAF = 1e-3


def batches(config: dict, tr: dict, data, client_indices,
            device) -> List[Dict[str, torch.Tensor]]:
    """The checked rounds' batches, worked out from the program's seed."""
    rnd = tr["round"]
    out = []
    for r in range(tr["check"]["rounds"]):
        b = round_batch(data, client_indices, tr["program_seed"], r,
                        rnd["num_workers"],
                        rnd["local_batch_size"],
                        augment=config["family"] == "resnet9")
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in b.items()})
    return out


def follow(config: dict, tr: dict, seed: int, data, client_indices, device,
           rounding: str = "float32", fault: str = "",
           after_round=None) -> dict:
    """The reference's (or, with ``rounding="fp8"`` or a ``fault``, a
    stand-in's) losses, momentum and parameters over the checked rounds."""
    precision.fp32_strict()
    w0 = weights.initial_params(config, seed, device)
    return ref_round.run(config, tr["optimizer"], tr["program_seed"], w0,
                         batches(config, tr, data, client_indices, device),
                         tr["lr"],
                         precision.ROUNDINGS[rounding],
                         tr["check"]["state_after"], fault, after_round)


def _leaf_norms(vec: torch.Tensor, config: dict) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(vec[o:o + n]))
                     for _, o, n in offsets(leaves(config))])


def _worst(cand: np.ndarray, ref: np.ndarray, floor: float,
           keep: np.ndarray) -> float:
    den = np.maximum(ref, floor)
    gap = np.abs(cand - ref)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(gap == 0, 0.0, gap / den)
    rel = np.where(np.isnan(cand), np.inf, rel)
    return float(rel[keep].max()) if keep.any() else 0.0


def numbers(config: dict, tr: dict, seed: int, cand: dict,
            ref: dict, detail: Optional[dict] = None) -> Dict[str, float]:
    """``cand`` (the program's or a stand-in's ``{"losses", "state",
    "params"}``) against the reference's."""
    opt = tr["optimizer"]
    dev = ref["params"].device
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(cand["losses"], ref["losses"])]
    cs, rs = cand["state"].to(dev), ref["state"]
    if opt["mode"] == "sketch":
        geo = countsketch.Geometry(ref["params"].numel(), opt["num_cols"],
                                   opt["num_rows"], tr["program_seed"])
        cs, rs = countsketch.estimate(geo, cs), countsketch.estimate(geo, rs)
    c_state, r_state = _leaf_norms(cs, config), _leaf_norms(rs, config)
    w0 = weights.initial_params(config, seed, dev)
    c_delta = _leaf_norms(cand["params"].to(dev) - w0, config)
    r_delta = _leaf_norms(ref["params"] - w0, config)
    keep = r_state >= SMALL_LEAF * np.median(r_state)
    moved = r_delta[r_delta > 0]
    if detail is not None:  # each leaf's norms, for the calibration
        detail.update(paths=[p for p, _ in leaves(config)],
                      state=(c_state.tolist(), r_state.tolist()),
                      delta=(c_delta.tolist(), r_delta.tolist()))
    return {
        "loss_gap": max(losses),
        "state_gap": _worst(c_state, r_state, float(np.median(r_state)),
                            np.ones_like(keep)),
        "delta_gap": _worst(c_delta, r_delta,
                            float(np.median(moved)) if moved.size else 0.0,
                            keep),
    }


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in NUMBERS)

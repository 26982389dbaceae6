"""How well ``chip_smoke.py``'s ``fused_bwd`` comparison is conditioned.

    python -m commefficient_tpu_torch.train.fused_bwd_probe
        [--seeds 42,1-8] [--rounds 5] [--device cuda|cpu]

The ``fused_bwd`` phase holds the params of five full-width ResNet-9
FetchSGD rounds with the sketch-fused backward to the same run with the
dense-grad fused gradient, at the reference's parity bound ``5e-5 *
max(|p|, 1)``. The two gradient tables differ only in the order of their
f32 sums, but the exact top-k (k = 50,000 of D = 6,573,130) meets
near-ties of whole groups: the coordinates whose median estimate comes
from one bucket share one ``|estimate|``, so a change in the last bits of
two buckets near the k-th value can swap two groups and move a few dozen
coordinates by about that value. This script runs both paths side by side
from the same state and batches for each seed (cuDNN deterministic, so
their cotangents are the same bits) and prints per round the two tables'
max difference over ``max|table|`` and the params' max difference and
count over the bound. The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json

import torch

from commefficient_tpu_torch import resolve_device
from commefficient_tpu_torch.data import FedSampler
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.utils.config import parse_args
from commefficient_tpu_torch.utils.schedule import piecewise_linear_lr

FETCHSGD = ["--mode", "sketch", "--k", "50000", "--num_rows", "5",
            "--num_cols", "500000", "--virtual_momentum", "0.9",
            "--error_type", "virtual", "--num_workers", "8",
            "--local_batch_size", "64", "--fuse_clients", "true"]


def _probe(seed: int, rounds: int, device: str) -> list:
    from commefficient_tpu_torch.train import cv_train

    base = FETCHSGD + ["--seed", str(seed), "--device", device]
    cfg_d = parse_args(base)
    cfg_f = parse_args(base + ["--sketch_fused_bwd", "true"])
    train, _, _, params, loss_fn, augment = cv_train.build_model_and_data(
        cfg_d)
    dense = FederatedSession(cfg_d, params, loss_fn)
    fused = FederatedSession(cfg_f, params, loss_fn)
    sampler = FedSampler(train, num_workers=8, local_batch_size=64,
                         seed=seed, augment=augment)
    rows = []
    for r in range(rounds):
        lr = piecewise_linear_lr(  # the runner's schedule
            r, steps_per_epoch=sampler.steps_per_epoch(),
            pivot_epoch=cfg_d.pivot_epoch, num_epochs=cfg_d.num_epochs,
            lr_scale=cfg_d.lr_scale)
        ids, batch = sampler.sample_round(r)
        dense.train_round(ids, batch, lr)
        fused.train_round(ids, batch, lr)
        p_d, p_f = dense.state.params_vec, fused.state.params_vec
        tol = 5e-5 * max(1.0, float(p_d.abs().max()))
        diff = (p_f - p_d).abs()
        m_d, m_f = dense.state.momentum, fused.state.momentum
        rows.append(dict(
            round=r, params_max_abs_err=float(diff.max()), tol=tol,
            coords_over_tol=int((diff > tol).sum()),
            momentum_max_err_over_max=float((m_f - m_d).abs().max())
            / max(float(m_d.abs().max()), 1e-30)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="42,1-8")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = ap.parse_args(argv)
    if ns.device == "cuda":
        resolve_device("cuda")
    seeds = []
    for part in ns.seeds.split(","):
        lo, _, hi = part.partition("-")
        seeds += range(int(lo), int(hi or lo) + 1)
    results = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for seed in seeds:
            rows = _probe(seed, ns.rounds, ns.device)
            results[seed] = rows
            for row in rows:
                print(f"seed {seed} " + " ".join(
                    f"{k}={v}" for k, v in row.items()), flush=True)
    finally:
        torch.backends.cudnn.deterministic = prev
    print(json.dumps({"device": ns.device, "results": results}))
    return results


if __name__ == "__main__":
    main()

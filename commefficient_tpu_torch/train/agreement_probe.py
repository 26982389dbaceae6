"""How well the width-8 card-against-CPU comparison is conditioned.

    python -m commefficient_tpu_torch.train.agreement_probe [--seeds 3-10]
        [--lrs 0.2,0.05] [--modes true_topk,...] [--device cuda|cpu]

``chip_smoke.py`` holds the card against the CPU with three rounds of a
width-8 ResNet-9 from fixed params and batches (``width8_session``), and
of FetchSGD on ``gpt2_tiny`` (``gpt2_tiny_session``, the mode
``gpt2_tiny``): the card's params must land within 1e-3 of how far the
CPU's moved. A
discrete near-tie (the k-th place of a top-k, a max-pool, a Gram–Schmidt
column near the subspace) can go one way on one device and the other way
on the other, and three rounds carry it on. This script measures how
often, per mode, seed and lr, printing ``|p_a - p_b| / |p_b - p0|`` for:

* ``cpu_perturbed``: the CPU against itself with the initial params
  changed by 1e-7 relative (what rounding alone can do to the
  trajectory; runs on any machine);
* with ``--device cuda``: ``card`` (default cuDNN algorithms) and
  ``card_det`` (``torch.backends.cudnn.deterministic``) against the CPU,
  and whether two default-cuDNN card runs are bit-equal (``card_rerun``).

The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import functools
import json
import warnings

import numpy as np
import torch

from commefficient_tpu_torch import resolve_device
from commefficient_tpu_torch.data import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    FedSampler,
    normalizer,
)
from commefficient_tpu_torch.models import (
    classification_loss,
    init_resnet9,
    resnet9_apply,
)
from commefficient_tpu_torch.parallel import FederatedSession, mask_gpt2
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.utils.config import Config

# the width-8 session's FetchSGD settings; a mode's own go over them
SKETCH_W8 = dict(mode="sketch", k=2000, num_rows=5, num_cols=20_000,
                 virtual_momentum=0.9, error_type="virtual")
MODES = {
    "sketch": {},
    "sketch_local_momentum": dict(local_momentum=0.9),
    "true_topk": dict(mode="true_topk"),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9),
    "fedavg": dict(mode="fedavg", error_type="none", num_local_iters=2),
    "powersgd": dict(mode="powersgd", powersgd_rank=4),
}


def width8_session(where: str, seed: int = 3, lr: float = 0.2,
                   perturb: float = 0.0, **cfg_kw):
    """(losses, p0, final params, decode) of three rounds at ``lr`` of a
    width-8 ResNet-9 in float32 on ``where`` from the params and batches
    of ``seed`` (2 clients of 8 images, client ids fixed): FetchSGD's
    settings with ``cfg_kw`` over them. ``perturb`` scales the initial
    params by ``1 + perturb * N(0, 1)`` (a seeded draw)."""

    def apply32(p, x):
        return resnet9_apply(p, x, dtype=torch.float32)

    loss_fn = classification_loss(apply32, prep=normalizer(CIFAR10_MEAN,
                                                           CIFAR10_STD))
    params = init_resnet9(seed, width=8)
    rng = np.random.default_rng(seed)
    batches = [{"x": rng.integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8),
                "y": rng.integers(0, 10, (2, 8)).astype(np.int32)}
               for _ in range(3)]
    ids = [np.array([0, 1]), np.array([2, 3]), np.array([1, 2])]
    cfg = Config(**{**SKETCH_W8, **cfg_kw}, num_workers=2, num_clients=4,
                 local_batch_size=8, compute_dtype="float32", device=where)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*degenerate")
        warnings.filterwarnings("ignore", message=".*dampening=AUTO")
        sess = FederatedSession(cfg, params, loss_fn)
    if perturb:
        gen = torch.Generator().manual_seed(seed)
        noise = torch.randn(sess.grad_size, generator=gen)
        sess.state.params_vec = sess.state.params_vec * (
            1 + perturb * noise.to(sess.device))
    p0 = sess.state.params_vec.cpu().clone()
    losses = [float(sess.train_round(i, microbatched(cfg, b), lr)["loss"])
              for i, b in zip(ids, batches)]
    return losses, p0, sess.state.params_vec.cpu(), sess.sketch_decode_resolved


# the gpt2_tiny session's FetchSGD settings
SKETCH_GPT2_TINY = dict(mode="sketch", k=500, num_rows=5, num_cols=20_000,
                        virtual_momentum=0.9, error_type="virtual",
                        model="gpt2_tiny", dataset_name="personachat",
                        max_seq_len=32, max_grad_norm=1.0)


def gpt2_tiny_session(where: str, seed: int = 3, lr: float = 0.2,
                      perturb: float = 0.0, **cfg_kw):
    """(losses, p0, final params, decode) of three FetchSGD rounds at
    ``lr`` of ``gpt2_tiny`` in float32 on ``where``: params from
    ``init_gpt2(seed)``, 2 clients of 2 dialogs a round from the
    synthetic PersonaChat's sampler (seed ``seed``); ``perturb`` as in
    ``width8_session``."""
    from commefficient_tpu_torch.train.gpt2_train import build_model_and_data

    cfg = Config(**{**SKETCH_GPT2_TINY, **cfg_kw}, num_workers=2,
                 num_clients=4, local_batch_size=2, compute_dtype="float32",
                 seed=seed, dataset_dir="/nonexistent", device=where)
    train, _, _, _, _, params, loss_fn = build_model_and_data(cfg)
    sess = FederatedSession(cfg, params, loss_fn, mask_batch=mask_gpt2)
    if perturb:
        gen = torch.Generator().manual_seed(seed)
        noise = torch.randn(sess.grad_size, generator=gen)
        sess.state.params_vec = sess.state.params_vec * (
            1 + perturb * noise.to(sess.device))
    p0 = sess.state.params_vec.cpu().clone()
    sampler = FedSampler(train, num_workers=2, local_batch_size=2, seed=seed)
    losses = [float(sess.train_round(*sampler.sample_round(r), lr)["loss"])
              for r in range(3)]
    return losses, p0, sess.state.params_vec.cpu(), sess.sketch_decode_resolved


def _session(case: str):
    """The session function of a probe case (a mode of ``MODES`` or
    ``gpt2_tiny``), with its settings."""
    if case == "gpt2_tiny":
        return gpt2_tiny_session
    return functools.partial(width8_session, **MODES[case])


def _ratio(p, ref, p0) -> float:
    return float(torch.linalg.vector_norm(p - ref)
                 / torch.linalg.vector_norm(ref - p0))


def _probe(session, seed, lr, card: bool):
    _, p0, cpu, _ = session("cpu", seed, lr)
    _, _, pert, _ = session("cpu", seed, lr, perturb=1e-7)
    out = {"cpu_perturbed": _ratio(pert, cpu, p0)}
    if card:
        runs = [session("cuda", seed, lr)[2] for _ in range(2)]
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            det = session("cuda", seed, lr)[2]
        finally:
            torch.backends.cudnn.deterministic = prev
        out.update(card=_ratio(runs[0], cpu, p0),
                   card_rerun_bit_equal=bool(torch.equal(*runs)),
                   card_det=_ratio(det, cpu, p0))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="3-10")
    ap.add_argument("--lrs", default="0.2,0.05")
    ap.add_argument("--modes", default=",".join([*MODES, "gpt2_tiny"]))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = ap.parse_args(argv)
    card = ns.device == "cuda"
    if card:
        resolve_device("cuda")
    lo, _, hi = ns.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    results = {}
    for case in ns.modes.split(","):
        for lr in (float(x) for x in ns.lrs.split(",")):
            rows = [_probe(_session(case), seed, lr, card)
                    for seed in seeds]
            results[f"{case}@{lr}"] = rows
            for key in rows[0]:
                vals = [r[key] for r in rows]
                shown = " ".join(f"{v:.1e}" if isinstance(v, float)
                                 else str(v) for v in vals)
                print(f"{case:22s} lr={lr:<5} {key:20s} seeds "
                      f"{seeds.start}..{seeds.stop - 1}: {shown}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0) if card
                      else "cpu", "seeds": list(seeds), "results": results}))
    return results


if __name__ == "__main__":
    main()

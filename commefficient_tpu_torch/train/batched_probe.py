"""What the batched client step's design rests on, measured on the card.

    python -m commefficient_tpu_torch.train.batched_probe [--device cuda]

ResNet-9 at full width (D = 6,573,130) on the synthetic CIFAR-10, one
round's 8 clients of 64 images, and random vectors for the top-k:

1. ``topk``: the exact top-k at k = 50,000 (CUDA events, median of 10):
   ``topk_dense`` (the mask form) on ``[8, D]`` and under ``vmap``, row
   by row, the ``nonzero`` form row by row (``topk_sparsify`` and a
   scatter, the loop's form before the batched step), and one row at
   GPT-2's D = 124,444,417 in both forms and ``torch.topk`` alone;
2. ``forms``: ``make_grad_one``'s ``torch.func`` form against its
   ``torch.autograd`` form (``batched=False``) on the round's flattened
   batch in mixed compute (max |difference| over max|gradient|), and
   each one's L2 distance from the gradient in f64 compute;
3. ``conditioning``: the f32 per-client gradients, the loop on
   deterministic cuDNN against the batched step, against the loop on
   default cuDNN and, for client 0, against the CPU (max |difference|
   over max).

The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics

import torch

from commefficient_tpu_torch import resolve_device
from commefficient_tpu_torch.data import FedSampler
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.models.resnet9 import resnet9_apply
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.ops.topk import topk_dense, topk_sparsify
from commefficient_tpu_torch.parallel.round import make_grad_one
from commefficient_tpu_torch.train import cv_train
from commefficient_tpu_torch.utils.config import parse_args

K = 50_000
GPT2_D = 124_444_417
PROBE_STREAM = 0  # the seed of the probe's random rows on the card


def _ms(fn, reps: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _nonzero_form(v, k):
    vals, idx = topk_sparsify(v, k)
    out = torch.zeros_like(v)
    out[idx] = vals
    return out


def _rel(a, b) -> float:
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def topk_times(dev, d: int):
    gen = torch.Generator(device=dev).manual_seed(PROBE_STREAM)
    rows = torch.randn(8, d, device=dev, generator=gen)
    big = torch.randn(GPT2_D, device=dev, generator=gen)
    want = torch.stack([_nonzero_form(r, K) for r in rows])
    out = {
        "mask_form_batched_ms": _ms(lambda: topk_dense(rows, K)),
        "mask_form_vmap_ms": _ms(lambda: torch.func.vmap(
            lambda r: topk_dense(r, K))(rows)),
        "mask_form_row_by_row_ms": _ms(lambda: [topk_dense(r, K)
                                                for r in rows]),
        "nonzero_form_row_by_row_ms": _ms(lambda: [_nonzero_form(r, K)
                                                   for r in rows]),
        "gpt2_row_mask_form_ms": _ms(lambda: topk_dense(big, K)),
        "gpt2_row_nonzero_form_ms": _ms(lambda: _nonzero_form(big, K)),
        "gpt2_row_torch_topk_ms": _ms(lambda: torch.topk(
            torch.abs(big), K, sorted=False)),
        "batched_equals_nonzero_form": bool(torch.equal(
            topk_dense(rows, K), want)),
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    dev = resolve_device(ns.device)
    if dev.type != "cuda":
        raise RuntimeError("batched_probe times the card; run it on a "
                           "machine with a GPU")
    cfg = parse_args(["--mode", "uncompressed", "--weight_decay", "0",
                      "--device", ns.device])
    train, _, _, params, _, _ = cv_train.build_model_and_data(cfg)
    vec, unravel = ravel_params(params)
    vec = vec.to(dev)
    _, batch = FedSampler(train, num_workers=8, local_batch_size=64,
                          seed=cfg.seed).sample_round(0)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    on_dev = {k: v.to(dev) for k, v in batch.items()}

    def loss_in(dtype):
        return classification_loss(
            functools.partial(resnet9_apply, dtype=dtype),
            prep=cv_train.normalizer(cv_train.CIFAR10_MEAN,
                                     cv_train.CIFAR10_STD))

    summary = {"card": torch.cuda.get_device_name(0),
               "topk": topk_times(dev, vec.numel())}
    print("topk:", json.dumps(summary["topk"]), flush=True)

    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in on_dev.items()}
    torch.backends.cudnn.deterministic = True
    grads = {}
    for name, dtype, batched in (("func", torch.bfloat16, True),
                                 ("autograd", torch.bfloat16, False),
                                 ("f64", torch.float64, False)):
        grads[name] = make_grad_one(cfg, loss_in(dtype), unravel,
                                    batched=batched)(vec, flat)[0]

    def dist(g):
        return float(torch.linalg.vector_norm(g - grads["f64"]))

    summary["forms"] = {
        "func_vs_autograd_max_err_over_max": _rel(grads["func"],
                                                  grads["autograd"]),
        "func_l2_from_f64": dist(grads["func"]),
        "autograd_l2_from_f64": dist(grads["autograd"]),
        "f64_l2": float(torch.linalg.vector_norm(grads["f64"]))}
    print("forms:", json.dumps(summary["forms"]), flush=True)
    del grads

    grad_one = make_grad_one(cfg, loss_in(torch.float32), unravel)

    def loop():
        return torch.stack([grad_one(vec, {k: v[i] for k, v in
                                           on_dev.items()})[0]
                            for i in range(8)])

    det = loop()
    batched = torch.func.vmap(grad_one, in_dims=(None, 0))(vec, on_dev)[0]
    torch.backends.cudnn.deterministic = False
    default = loop()
    cpu = make_grad_one(cfg.replace(device="cpu"), loss_in(torch.float32),
                        unravel)(vec.cpu(), {k: v[0] for k, v in
                                             batch.items()})[0]
    summary["conditioning"] = {
        "batched_vs_loop": _rel(batched, det),
        "loop_default_cudnn_vs_loop": _rel(default, det),
        "client0_loop_vs_cpu": _rel(det[0].cpu(), cpu)}
    print("conditioning:", json.dumps(summary["conditioning"]), flush=True)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""cv_train — the CV workload entry point of the port.

Same flags as ``commefficient_tpu.train.cv_train`` for everything this slice
runs, plus ``--device`` (``cuda`` by default, ``cpu`` for the plain path)
and ``--max_rounds``. The FetchSGD main path on one H100:

  python -m commefficient_tpu_torch.train.cv_train --mode sketch --k 50000 \\
      --num_rows 5 --num_cols 500000 --virtual_momentum 0.9 \\
      --error_type virtual --sketch_backend pallas --num_workers 8 \\
      --num_devices 1 --local_batch_size 64
"""

from __future__ import annotations

import functools

import torch

from commefficient_tpu_torch.data import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    FedSampler,
    augment_batch,
    load_fed_cifar10,
    normalizer,
)
from commefficient_tpu_torch.models import (
    classification_loss,
    init_resnet9,
    model_dtype,
    resnet9_apply,
)
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.config import Config, parse_args


def build_model_and_data(cfg: Config, width: int = 64):
    """(train, test, is_real, params, loss_fn, augment) for cifar10 +
    ResNet-9. Images stay uint8 on the host; the loss normalizes them on
    the device."""
    train, test, real = load_fed_cifar10(
        cfg.dataset_dir, num_clients=cfg.num_clients, iid=cfg.iid,
        seed=cfg.seed, synthetic_variant=cfg.synthetic_variant)
    params = init_resnet9(cfg.seed, num_classes=10, width=width)
    apply = functools.partial(resnet9_apply,
                              dtype=model_dtype(cfg.compute_dtype))
    loss_fn = classification_loss(
        apply, prep=normalizer(CIFAR10_MEAN, CIFAR10_STD))
    return train, test, real, params, loss_fn, augment_batch


class _CvHooks(WorkloadHooks):
    def __init__(self, session, test_ds, eval_batch_size):
        self.session = session
        self.test_ds = test_ds
        self.eval_batch_size = eval_batch_size

    def new_accumulator(self):
        return {"loss": 0.0, "correct": 0.0, "count": 0.0}

    def accumulate(self, acc, loss, metrics):
        acc["loss"] += loss
        acc["correct"] += float(metrics.get("correct", 0.0))
        acc["count"] += float(metrics.get("count", 0.0))

    def evaluate(self):
        return self.session.evaluate(
            self.test_ds.eval_batches(self.eval_batch_size))

    def epoch_row(self, *, epoch, lr, acc, val, train_time, val_time,
                  rounds):
        return {
            "epoch": epoch + 1,
            "lr": lr,
            "train_loss": acc["loss"] / rounds,
            "train_acc": acc["correct"] / max(acc["count"], 1.0),
            "val_loss": val["loss"],
            "val_acc": val.get("accuracy", float("nan")),
            "train_time": train_time,
            "val_time": val_time,
        }


def main(argv=None, eval_batch_size: int = 512, **overrides):
    """Train and evaluate. Returns the final val metrics plus ``history``
    (per-round step/lr/loss/ms), ``grad_size``, ``bytes_per_round`` and
    ``param_delta_norm`` (how far the run moved the params)."""
    cfg = parse_args(argv, **overrides)
    train, test, real, params, loss_fn, augment = build_model_and_data(cfg)
    print(f"dataset={cfg.dataset_name} (real={real}) model={cfg.model} "
          f"mode={cfg.mode} clients={train.num_clients} "
          f"workers={cfg.num_workers} device={cfg.device}")
    if not real:
        print("WARNING: real dataset not found on disk — synthetic stand-in "
              "(pipeline-correct; metrics are not paper numbers)")
    session = FederatedSession(cfg, params, loss_fn)
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.local_batch_size,
                         seed=cfg.seed, augment=augment)
    bpr = session.bytes_per_round()
    print(f"grad_size D={session.grad_size}  upload/client/round="
          f"{bpr['upload_bytes']:,} B  download={bpr['download_bytes']:,} B")
    p0 = session.state.params_vec.clone()
    val, history = run_train_loop(
        cfg, session, sampler, _CvHooks(session, test, eval_batch_size),
        on_round=lambda r: print(
            f"round {r['step']}: lr={r['lr']:.6f} loss={r['loss']:.6f} "
            f"ms={r['ms']:.2f}", flush=True))
    print(f"final: val_loss={val['loss']:.4f} "
          f"val_acc={val.get('accuracy', 0):.4f}")
    moved = torch.linalg.vector_norm(session.state.params_vec - p0)
    return {**val, "history": history, "grad_size": session.grad_size,
            "bytes_per_round": bpr, "param_delta_norm": float(moved)}


if __name__ == "__main__":
    main()

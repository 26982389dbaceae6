"""cv_train — the CV workload entry point of the port.

Same flags as ``commefficient_tpu.train.cv_train`` for everything this slice
runs, plus ``--device`` (``cuda`` by default, ``cpu`` for the plain path)
and ``--max_rounds``. The FetchSGD main path on one H100:

  python -m commefficient_tpu_torch.train.cv_train --mode sketch --k 50000 \\
      --num_rows 5 --num_cols 500000 --virtual_momentum 0.9 \\
      --error_type virtual --sketch_backend pallas --num_workers 8 \\
      --num_devices 1 --local_batch_size 64

The sharded server decode adds ``--topk_method threshold --sketch_decode
sharded``; one process per card runs it over N cards:

  torchrun --nproc_per_node N -m commefficient_tpu_torch.train.cv_train \\
      ... --num_devices N

The paper's other modes take the same flags with their own:

  --mode true_topk --k 50000 --virtual_momentum 0.9 --error_type virtual
  --mode local_topk --k 50000 --error_type local --local_momentum 0.9 \\
      --num_clients 100
  --mode fedavg --num_local_iters 2 [--local_lr 0.1]
  --mode powersgd --powersgd_rank 4 --virtual_momentum 0.9 \\
      --error_type virtual
  --mode uncompressed --virtual_momentum 0.9 --fuse_clients true

The sketch-fused backward (the fused flattened-batch gradient produced as a
table, no flat [D] gradient): ``--fuse_clients true --sketch_fused_bwd
true`` over the FetchSGD flags. Partial participation and chaos:
``--availability bernoulli --dropout_prob 0.3 --chaos "straggler@0.1"``.
Worker-side DP: ``--max_grad_norm 1.0 --dp_noise_multiplier 0.5``.
Checkpoint/resume: ``--checkpoint_dir DIR --checkpoint_every N [--resume
true]``. Failure handling (``--telemetry_level 1``): ``--recover_policy
retry|demote|skip_clients --snapshot_every N [--max_recoveries M]`` rolls
a diverged run back to its last snapshot and goes on (the runner prints
the rider's ``resilience:`` line); ``--preempt_signals true`` (or chaos
``preempt@R``) turns SIGTERM/SIGINT into a drained, force-saved exit with
code 75.

(fedavg's sampler draws ``num_local_iters * local_batch_size`` samples a
client, split into that many local steps.)

The other datasets and FixupResNet-50 (BASELINE #3 and #5):

  --dataset_name femnist --mode local_topk --error_type local \
      --local_momentum 0.9 --num_clients 100
  --dataset_name imagenet --model fixup_resnet50 --mode fedavg \
      --num_local_iters 2
  --dataset_name cifar100 ...

Real LEAF FEMNIST json shards, an ImageNet ``.npy`` cache or ImageFolder
tree, and the CIFAR-100 pickles are read from ``--dataset_dir`` when
present; otherwise the synthetic stand-ins (ImageNet at 64 px). When the
training set fits ``--device_data_max_mb`` (512 MB by default) it lives on
the device and each round ships only indices and the augment plan; the
header line says which path runs (``data=device|host``), and
``--device_data false`` keeps the host path.

The host side of a round: the sampler assembles a batch in the native C++
library (``native=yes`` in the header; numpy where it cannot be built) in
a background thread two rounds ahead. ``--pipeline_depth N`` (N > 0) runs
the pipelined engine instead: a worker realizes N rounds ahead and copies
each round's arrays to the card early (pinned buffers, a side stream), and
the values stay those of depth 0. ``--async_buffer K`` runs the
buffered-asynchronous engine instead (``asyncfed/``: C cohorts in flight,
an update each K arrivals, staleness-discounted; K = W, C = 1, exponent 0
is the synchronous round bit for bit).

Telemetry: rank 0 writes ``metrics.jsonl`` into a run dir under
``--logdir`` (``runs`` by default; ``--tensorboard true`` adds
TensorBoard); ``--telemetry_level 1`` adds the ``diag/*`` and ``comm/*``
scalars, ``comm_ledger.json`` and the flight recorder (a non-finite round
raises ``DivergenceError`` and dumps ``flight_<step>.json``), the host
spans (``spans_<step>.json``, the ``trace/*`` and
``xla/exposed_collective_ms`` scalars), ``perf_report.json`` (round 0's
FLOPs, peak memory and collectives; ``--perf_audit false`` drops it) and
``run_report.json`` (``--run_report false`` drops it), level 2 the
compressors' fidelity; ``--profile_dir DIR`` traces rounds 5-7 with
``torch.profiler``, ``--profile_rounds A-B`` the rounds A to B.
"""

from __future__ import annotations

import functools

import torch

from commefficient_tpu_torch.data import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    FedSampler,
    ImageNetAugment,
    augment_batch,
    load_fed_cifar10,
    load_fed_cifar100,
    load_fed_emnist,
    load_fed_imagenet,
    normalizer,
)
from commefficient_tpu_torch.models import (
    FIXUP_RESNET50_STAGES,
    classification_loss,
    fixup_resnet_apply,
    init_fixup_resnet,
    init_resnet9,
    model_dtype,
    resnet9_apply,
)
from commefficient_tpu_torch import native
from commefficient_tpu_torch.control import controller_header
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.mesh import distributed_from_env
from commefficient_tpu_torch.resilience import EXIT_PREEMPTED, PreemptShutdown
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.config import CV_MODELS, Config, parse_args
from commefficient_tpu_torch.utils.logging import MetricsWriter, make_logdir


def load_dataset(cfg: Config):
    """(train, test, is_real, num_classes, in_channels, augment, prep) for
    ``cfg.dataset_name``. Images stay as loaded on the host (uint8, or the
    float32 stand-ins); ``prep`` normalizes uint8 on the device inside the
    loss (None: no normalizer)."""
    name = cfg.dataset_name
    if name in ("cifar10", "cifar100"):
        if name == "cifar10":
            train, test, real = load_fed_cifar10(
                cfg.dataset_dir, num_clients=cfg.num_clients, iid=cfg.iid,
                seed=cfg.seed, synthetic_variant=cfg.synthetic_variant)
        else:
            train, test, real = load_fed_cifar100(
                cfg.dataset_dir, num_clients=cfg.num_clients, iid=cfg.iid,
                seed=cfg.seed)
        return (train, test, real, cfg.resolved_num_classes, 3,
                augment_batch, normalizer(CIFAR10_MEAN, CIFAR10_STD))
    if name == "femnist":
        train, test, real = load_fed_emnist(
            cfg.dataset_dir, num_clients=cfg.num_clients, seed=cfg.seed,
            label_noise=cfg.label_noise)
        return train, test, real, 62, 1, None, None
    # imagenet: num_classes reaches the loader, so the stand-in's labels
    # stay below the head's size
    train, test, real = load_fed_imagenet(
        cfg.dataset_dir, num_clients=cfg.num_clients, iid=cfg.iid,
        seed=cfg.seed, num_classes=cfg.resolved_num_classes)
    return (train, test, real, cfg.resolved_num_classes,
            train.data["x"].shape[-1], ImageNetAugment(),
            normalizer(IMAGENET_MEAN, IMAGENET_STD))


def build_model_and_data(cfg: Config, **model_kw):
    """(train, test, is_real, params, loss_fn, augment) for
    ``cfg.dataset_name`` and ``cfg.model``. ``model_kw`` narrows the model
    (ResNet-9's ``width``; FixupResNet's ``stage_sizes`` and ``width``)."""
    train, test, real, classes, channels, augment, prep = load_dataset(cfg)
    mdt = model_dtype(cfg.compute_dtype)
    if cfg.model == "resnet9":
        params = init_resnet9(cfg.seed, num_classes=classes,
                              in_channels=channels, **model_kw)
        apply = functools.partial(resnet9_apply, dtype=mdt)
    else:  # fixup_resnet50 and its alias resnet50
        if channels != 3:
            raise ValueError(f"{cfg.model} takes RGB images; "
                             f"{cfg.dataset_name} has {channels} channel")
        params = init_fixup_resnet(
            cfg.seed, model_kw.pop("stage_sizes", FIXUP_RESNET50_STAGES),
            num_classes=classes, **model_kw)
        apply = functools.partial(fixup_resnet_apply, dtype=mdt)
    loss_fn = classification_loss(apply, prep=prep,
                                  compute_dtype=cfg.compute_dtype)
    return train, test, real, params, loss_fn, augment


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

    def write_val(self, writer, val, step):
        writer.scalar("val/loss", val["loss"], step)
        writer.scalar("val/acc", val.get("accuracy", 0.0), step)

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


def main(argv=None, eval_batch_size: int = 512, model_kw=None, **overrides):
    """Train and evaluate. Returns the final val metrics plus ``history``
    (per-round step/lr/loss/ms/data_ms), ``grad_size``, ``bytes_per_round``,
    ``param_delta_norm`` (how far the run moved the params) and
    ``sketch_decode`` (the server decode the session ran), ``checkpoint``
    (the runner's checkpoint facts), ``final_step``, ``data_path``
    (``device`` or ``host``), ``pipeline_stats`` (the pipelined engine's
    or the buffered-async engine's ``stats()``, None on the synchronous
    loop), ``logdir`` (rank 0's run dir, None on the other ranks) and
    ``control`` (the control plane's controller ``snapshot()`` at the
    end, None without it) and ``fleet`` (the elastic fleet's ``width``
    at the end, ``resize_ms`` its width switches' host ms and
    ``shrink_recoveries``; None without a fleet event). ``model_kw`` narrows the model
    (``build_model_and_data``). Under
    ``torchrun`` with ``--num_devices N`` each process is one rank of the
    worker group; rank 0 alone evaluates and prints, and the other ranks'
    val metrics are empty."""
    cfg = parse_args(argv, **overrides)
    if cfg.model not in CV_MODELS:
        raise ValueError(f"cv_train trains {CV_MODELS}, got model="
                         f"{cfg.model!r} (GPT-2: python -m "
                         "commefficient_tpu_torch.train.gpt2_train)")
    with distributed_from_env(cfg):
        return _train(cfg, eval_batch_size, model_kw or {})


def _train(cfg: Config, eval_batch_size: int, model_kw: dict):
    train, test, real, params, loss_fn, augment = build_model_and_data(
        cfg, **model_kw)
    session = FederatedSession(cfg, params, loss_fn)
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size,
                         seed=cfg.seed, augment=augment)
    session.maybe_attach_data(train, sampler, augment)
    say = print if session.is_lead else (lambda *a, **k: None)
    say(f"dataset={cfg.dataset_name} (real={real}) model={cfg.model} "
        f"mode={cfg.mode} clients={train.num_clients} "
        f"workers={cfg.num_workers} devices={session.group.size} "
        f"device={session.device} decode={session.sketch_decode_resolved} "
        f"aggregate={session.aggregate_resolved} "
        f"data={session.data_path} "
        f"native={'yes' if native.available() else 'no'} "
        f"pipeline_depth={cfg.pipeline_depth}")
    if not real:
        say("WARNING: real dataset not found on disk — synthetic stand-in "
            "(pipeline-correct; metrics are not paper numbers)")
    bpr = session.bytes_per_round()
    say(f"grad_size D={session.grad_size}  upload/client/round="
        f"{bpr['upload_bytes']:,} B  download={bpr['download_bytes']:,} B")
    p0 = session.full_params_vec().clone()
    pipeline_stats = {}
    writer = (MetricsWriter(make_logdir(cfg), cfg.tensorboard, cfg=cfg,
                            extra_header=controller_header(session))
              if session.is_lead else None)
    try:
        val, history, ckpt = run_train_loop(
            cfg, session, sampler, _CvHooks(session, test, eval_batch_size),
            on_round=lambda r: print(
                f"round {r['step']}: lr={r['lr']:.6f} loss={r['loss']:.6f} "
                f"ms={r['ms']:.2f}", flush=True),
            engine_stats=pipeline_stats, writer=writer,
            generated_by="commefficient_tpu_torch.train.cv_train")
    except PreemptShutdown as e:
        # drained and force-saved by the runner: the distinct exit code
        # tells an orchestrator to rerun with --resume
        say(str(e))
        raise SystemExit(EXIT_PREEMPTED) from e
    finally:
        if writer is not None:
            writer.close()
    if val:
        say(f"final: val_loss={val['loss']:.4f} "
            f"val_acc={val.get('accuracy', 0):.4f}")
    moved = torch.linalg.vector_norm(session.full_params_vec() - p0)
    return {**val, "history": history, "grad_size": session.grad_size,
            "bytes_per_round": bpr, "param_delta_norm": float(moved),
            "sketch_decode": session.sketch_decode_resolved,
            "aggregate": session.aggregate_resolved,
            "checkpoint": ckpt, "final_step": session.state.step,
            "data_path": session.data_path,
            "pipeline_stats": pipeline_stats or None,
            "logdir": writer.logdir if writer is not None else None,
            "control": (session.controller.snapshot()
                        if session.controller is not None else None),
            "fleet": ({"width": session._fleet_width,
                       "resize_ms": session._fleet_resize_ms,
                       "shrink_recoveries": session._fleet_shrink_recoveries}
                      if cfg.fleet_enabled else None)}


if __name__ == "__main__":
    main()

"""The train-loop runner (the reference's ``train/runner.py``, minimal).

Epoch loop with the piecewise-linear lr, one round per step, the round's
loss read back every round, an end-of-epoch eval and a console row.
Checkpoint/resume (``utils/checkpoint.py``): with ``cfg.resume`` the
newest checkpoint is restored and the loop fast-forwards to its round (the
sampler, the lr schedule and the fedsim environment are pure functions of
the round, so the resumed run is the unbroken one); a save every
``checkpoint_every`` rounds and a forced one at the end. The chaos plan's
rounds are checked against the run length at entry. The reference's
resilience, pipelining and telemetry are not ported (``Config`` refuses
their flags). ``cfg.max_rounds > 0`` stops the run once ``max_rounds``
rounds are done and evaluates once. With the training set on the device
(``session.data_path == "device"``) each round is drawn as indices and
the augment plan (``sampler.sample_round_indices``) and run by
``session.train_round_indices``; both forms are pure functions of the
round, so a resume fast-forwards the same way on either path.
"""

from __future__ import annotations

import time
from functools import partial

from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer
from commefficient_tpu_torch.utils.schedule import piecewise_linear_lr


class TableLogger:
    """Aligned console table, one row per epoch."""

    def __init__(self, width: int = 12):
        self.width = width
        self._keys = None

    def append(self, row: dict) -> None:
        if self._keys is None:
            self._keys = list(row)
            print(" | ".join(f"{k:>{self.width}s}" for k in self._keys))
        cells = []
        for k in self._keys:
            v = row.get(k, "")
            cells.append(f"{v:>{self.width}.4f}" if isinstance(v, float)
                         else f"{str(v):>{self.width}s}")
        print(" | ".join(cells), flush=True)


class WorkloadHooks:
    """What a workload entry plugs into the runner."""

    def new_accumulator(self):
        raise NotImplementedError

    def accumulate(self, acc, loss, metrics) -> None:
        raise NotImplementedError

    def evaluate(self) -> dict:
        raise NotImplementedError

    def epoch_row(self, *, epoch, lr, acc, val, train_time, val_time,
                  rounds) -> dict:
        raise NotImplementedError

    def on_epoch_end(self, epoch: int, val: dict) -> None:
        """Called on rank 0 after each epoch's evaluation (GPT-2: a sample
        generation)."""


def run_train_loop(cfg, session, sampler, hooks: WorkloadHooks, table=None,
                   on_round=None):
    """Run the epochs; returns ``(final val metrics, per-round history,
    checkpoint facts)``, the facts ``{"resumed_from", "save_ms",
    "restore_ms", "bytes"}`` (the round the run resumed from, 0 for a
    fresh run; the last save's and the restore's wall ms and the last
    file's bytes, None where none happened). History rows are ``{"step",
    "lr", "loss", "ms", "data_ms"}`` (and the ``fedsim/*`` scalars under
    fedsim), ``ms`` the host wall time of the round up to its loss
    read-back (which waits for the device), ``data_ms`` the host time of
    the sampler's draw before it (on the host path the gather and augment
    too). In a worker group every rank draws the same
    rounds (same sampler seed) and trains; rank 0 alone
    evaluates, prints and writes checkpoints, and the other ranks return
    empty val metrics. Epochs wholly before the resumed round are
    skipped, evaluation included."""
    main = session.group.rank == 0
    steps_per_epoch = sampler.steps_per_epoch()
    num_rounds = steps_per_epoch * cfg.num_epochs
    if session.fedsim_env is not None:
        # only here is the run length known (it derives from the dataset)
        session.fedsim_env.validate_rounds(num_rounds)
        if main:
            print(session.fedsim_env.describe())
    lr_fn = partial(piecewise_linear_lr, steps_per_epoch=steps_per_epoch,
                    pivot_epoch=cfg.pivot_epoch, num_epochs=cfg.num_epochs,
                    lr_scale=cfg.lr_scale)
    checkpointer = FedCheckpointer(cfg)
    start = 0
    if cfg.resume:
        restored = checkpointer.restore(session)
        if restored is not None:
            start = restored
            if main:
                print(f"resumed from checkpoint at round {start}")
    last = min(num_rounds, cfg.max_rounds) if cfg.max_rounds else num_rounds
    on_device = session.data_path == "device"
    table = table or TableLogger()
    history = []
    val = {}
    for epoch in range(cfg.num_epochs):
        if (epoch + 1) * steps_per_epoch <= start:
            continue  # fast-forward over the epochs before the resume
        if epoch * steps_per_epoch >= last:
            break
        t_epoch = time.perf_counter()
        acc = hooks.new_accumulator()
        rounds = 0
        lr = float(lr_fn(epoch * steps_per_epoch))
        for s in range(max(start, epoch * steps_per_epoch),
                       min(last, (epoch + 1) * steps_per_epoch)):
            lr = float(lr_fn(s))
            t_draw = time.perf_counter()
            if on_device:  # (client ids, [W, B] indices, the plan)
                drawn = sampler.sample_round_indices(s)
                run = session.train_round_indices
            else:  # (client ids, the host batch)
                client_ids, batch = sampler.sample_round(s)
                drawn = (client_ids, microbatched(cfg, batch))
                run = session.train_round
            t0 = time.perf_counter()
            metrics = run(*drawn, lr)
            loss = float(metrics["loss"])
            row = {"step": s, "lr": lr, "loss": loss,
                   "ms": 1e3 * (time.perf_counter() - t0),
                   "data_ms": 1e3 * (t0 - t_draw),
                   **{k: float(v) for k, v in metrics.items()
                      if k.startswith("fedsim/")}}
            history.append(row)
            if on_round is not None and main:
                on_round(row)
            hooks.accumulate(acc, loss, metrics)
            rounds += 1
            checkpointer.maybe_save(session, s + 1)
        train_time = time.perf_counter() - t_epoch
        if main:
            t_val = time.perf_counter()
            val = hooks.evaluate()
            table.append(hooks.epoch_row(
                epoch=epoch, lr=lr, acc=acc, val=val, train_time=train_time,
                val_time=time.perf_counter() - t_val, rounds=max(rounds, 1)))
            hooks.on_epoch_end(epoch, val)
    # the end-of-training save: a run's last rounds past the final
    # checkpoint_every boundary would otherwise be lost to a resume
    checkpointer.maybe_save(session, session.state.step, force=True)
    return val, history, {"resumed_from": start,
                          "save_ms": checkpointer.last_save_ms,
                          "restore_ms": checkpointer.last_restore_ms,
                          "bytes": checkpointer.last_bytes}

"""The train-loop runner (the reference's ``train/runner.py``, minimal).

Epoch loop with the piecewise-linear lr, one round per step, the round's
loss read back every round, an end-of-epoch eval and a console row. The
reference's checkpointing, resilience, pipelining and telemetry are not
ported (``Config`` refuses their flags). ``cfg.max_rounds > 0`` stops the
run after that many rounds and evaluates once.
"""

from __future__ import annotations

import time
from functools import partial

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


def run_train_loop(cfg, session, sampler, hooks: WorkloadHooks, table=None,
                   on_round=None):
    """Run the epochs; returns ``(final val metrics, per-round history)``.
    History rows are ``{"step", "lr", "loss", "ms"}``, ``ms`` the host wall
    time of the round up to its loss read-back (which waits for the
    device)."""
    steps_per_epoch = sampler.steps_per_epoch()
    lr_fn = partial(piecewise_linear_lr, steps_per_epoch=steps_per_epoch,
                    pivot_epoch=cfg.pivot_epoch, num_epochs=cfg.num_epochs,
                    lr_scale=cfg.lr_scale)
    table = table or TableLogger()
    history = []
    val = {}
    for epoch in range(cfg.num_epochs):
        t_epoch = time.perf_counter()
        acc = hooks.new_accumulator()
        rounds = 0
        lr = float(lr_fn(epoch * steps_per_epoch))
        for s in range(epoch * steps_per_epoch,
                       (epoch + 1) * steps_per_epoch):
            if cfg.max_rounds and s >= cfg.max_rounds:
                break
            client_ids, batch = sampler.sample_round(s)
            lr = float(lr_fn(s))
            t0 = time.perf_counter()
            metrics = session.train_round(client_ids, batch, lr)
            loss = float(metrics["loss"])
            row = {"step": s, "lr": lr, "loss": loss,
                   "ms": 1e3 * (time.perf_counter() - t0)}
            history.append(row)
            if on_round is not None:
                on_round(row)
            hooks.accumulate(acc, loss, metrics)
            rounds += 1
        train_time = time.perf_counter() - t_epoch
        t_val = time.perf_counter()
        val = hooks.evaluate()
        table.append(hooks.epoch_row(
            epoch=epoch, lr=lr, acc=acc, val=val, train_time=train_time,
            val_time=time.perf_counter() - t_val, rounds=max(rounds, 1)))
        if cfg.max_rounds and len(history) >= cfg.max_rounds:
            break
    return val, history

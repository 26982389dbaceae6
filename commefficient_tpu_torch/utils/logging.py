"""Console and metrics logging (the port's copy of the reference's
``utils/logging.py``).

``Timer`` and ``TableLogger`` are the console side (one row per epoch);
``MetricsWriter`` is the run's scalar sink: ``metrics.jsonl`` in the run
dir (``make_logdir``), one strict-JSON record a line, a run header first,
and TensorBoard beside it when asked and importable. ``drain_round_metrics``
is where the rounds' device metrics come back to the host: the train loop
keeps each round's ``(step, lr, metrics)`` without reading anything and
drains them at epoch end and before a checkpoint, as ONE stack on the
device and ONE copy to the host (``pack_metric_dicts``), then writes the
scalars and feeds the telemetry riders (the ``CommLedger`` and the
``FlightRecorder``) in step order.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch


class Timer:
    """Accumulating phase timer: ``t()`` returns seconds since the last
    call."""

    def __init__(self):
        self._last = time.perf_counter()
        self.total = 0.0

    def __call__(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.total += dt
        return dt


class TableLogger:
    """Aligned console table, one row per epoch. A key that first appears
    after the header row warns once and is rendered from then on (the
    header is not printed again)."""

    def __init__(self, width: int = 12):
        self.width = width
        self._keys: Optional[list] = None

    def append(self, row: dict) -> None:
        if self._keys is None:
            self._keys = list(row)
            print(" | ".join(f"{k:>{self.width}s}" for k in self._keys))
        else:
            for k in row:
                if k not in self._keys:
                    print(f"TableLogger: new column {k!r} appeared after "
                          "the header row; rendering it in subsequent rows "
                          "(header not reprinted)", flush=True)
                    self._keys.append(k)
        cells = []
        for k in self._keys:
            v = row.get(k, "")
            cells.append(f"{v:>{self.width}.4f}" if isinstance(v, float)
                         else f"{str(v):>{self.width}s}")
        print(" | ".join(cells), flush=True)


def make_logdir(cfg) -> str:
    """The run dir under ``cfg.logdir``, named by the salient config
    fields and the start time (the reference's name)."""
    tag = (f"{cfg.dataset_name}_{cfg.model}_{cfg.mode}_w{cfg.num_workers}"
           f"_s{cfg.seed}")
    return os.path.join(cfg.logdir, tag + "_" + time.strftime("%Y%m%d-%H%M%S"))


class MetricsWriter:
    """Scalar sink: ``metrics.jsonl`` always, TensorBoard
    (``torch.utils.tensorboard``) when ``enable_tensorboard`` and it
    imports, else a warning and JSONL only.

    Every open writes a run-header record first (schema version, config,
    torch and device identity, wall-clock start: ``telemetry.run_metadata``)
    and every scalar record carries its wall time ``t``; a non-finite value
    is written as the marker ``"nan"``/``"inf"``/``"-inf"``, so each line
    stays strict JSON. A resumed run appends a second header."""

    def __init__(self, logdir: str, enable_tensorboard: bool = False,
                 cfg=None, extra_header=None):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._write_header(cfg, extra_header)
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except ImportError as e:
                warnings.warn(f"MetricsWriter: tensorboard unavailable "
                              f"({type(e).__name__}: {e}); logging "
                              "JSONL-only", stacklevel=2)

    def _write_header(self, cfg, extra_header=None) -> None:
        from commefficient_tpu_torch.telemetry import (
            SCHEMA_VERSION,
            jsonable_tree,
            run_artifacts,
            run_metadata,
        )

        rec = {"type": "header", "schema_version": SCHEMA_VERSION,
               **run_metadata(cfg)}
        if cfg is not None:
            arts = run_artifacts(cfg, self.logdir)
            if arts:
                rec["artifacts"] = arts
        if extra_header:
            rec.update(extra_header)
        self._jsonl.write(json.dumps(jsonable_tree(rec), allow_nan=False)
                          + "\n")
        self._jsonl.flush()

    def scalar(self, name: str, value: float, step: int) -> None:
        from commefficient_tpu_torch.telemetry import jsonable_scalar

        self._jsonl.write(json.dumps(
            {"name": name, "value": jsonable_scalar(value), "step": int(step),
             "t": time.time()}, allow_nan=False) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), int(step))

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def pack_metric_dicts(dicts):
    """N same-keyed metric dicts as ``(names, mat)``, ``mat [N, K]`` f32
    numpy with ``mat[j, i] == float(dicts[j][names[i]])``: every tensor
    value goes into ONE ``torch.stack`` on its device and ONE copy to the
    host (a read per scalar would wait on the device once per scalar);
    host numbers (the ``fedsim/*`` stats) are filled in directly. A dict
    whose keys differ from the first's is refused, named."""
    names = tuple(sorted(dicts[0]))
    for j, m in enumerate(dicts):
        if tuple(sorted(m)) != names:
            raise ValueError(
                f"pack_metric_dicts: mixed key sets — dict {j} has "
                f"{tuple(sorted(m))}, expected {names}; all packed metric "
                "dicts must share one key set")
    mat = np.empty((len(dicts), len(names)), np.float32)
    where, tensors = [], []
    for j, m in enumerate(dicts):
        for i, k in enumerate(names):
            v = m[k]
            if torch.is_tensor(v):
                where.append((j, i))
                tensors.append(v.detach().reshape(()).to(torch.float32))
            else:
                mat[j, i] = np.float32(v)
    if tensors:
        host = torch.stack(tensors).cpu().numpy()
        for (j, i), x in zip(where, host):
            mat[j, i] = x
    return names, mat


def drain_round_metrics(pending, writer, accumulate, ledger=None,
                        flight=None, controller=None) -> None:
    """Read back the buffered rounds ``pending`` (a list of ``(step, lr,
    metrics)`` in step order) in one packed copy and clear it.

    For each round, in step order: the writer gets ``train/loss``, ``lr``
    and every namespaced key (a key holding ``/``: ``diag/*``,
    ``fedsim/*``), then the ledger's ``comm/*``; ``accumulate(loss,
    metrics)`` gets the host values; the control plane's ``controller``
    (``observe_drained(step, metrics)``) feeds the round to its policy, the
    ``ef_feedback`` loop's input; the flight recorder records the round
    and checks it, raising ``DivergenceError`` at the first bad round. The
    buffer is cleared and the writer flushed even then, so the bad rounds'
    scalars are on disk for the post-mortem."""
    if not pending:
        return
    names, mat = pack_metric_dicts([m for _, _, m in pending])
    try:
        for j, (s, s_lr, _) in enumerate(pending):
            metrics = {k: float(mat[j, i]) for i, k in enumerate(names)}
            loss = metrics["loss"]
            if writer:
                writer.scalar("train/loss", loss, s)
                writer.scalar("lr", s_lr, s)
                for k in names:
                    if "/" in k:
                        writer.scalar(k, metrics[k], s)
            comm = ledger.on_round(s, metrics) if ledger is not None else {}
            if writer:
                for k, v in comm.items():
                    writer.scalar(k, v, s)
            accumulate(loss, metrics)
            if controller is not None:
                controller.observe_drained(s, metrics)
            if flight is not None:
                flight.record(s, s_lr, {**metrics, **comm})
                flight.check(s, loss, metrics)  # may raise DivergenceError
    finally:
        pending.clear()
        if writer:
            writer.flush()

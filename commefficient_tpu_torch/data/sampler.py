"""FedSampler — per-round client participation and batch assembly.

The port's own copy of ``commefficient_tpu/data/sampler.py``: each round
draws ``num_workers`` distinct clients and one flat ``[W*B]`` gather (+
plan-based augmentation) from ``default_rng((seed, round))``, the same draw
sequence as the reference, so the same seed gives the same batches in both
packages. The gather and augment run fused in the native C++ library
(``commefficient_tpu_torch/native``, bit-equal to numpy) where it builds,
and in numpy otherwise; ``native.available()`` says which.

``sample_round_indices`` is the index-only form for the device-resident
training set: the same draws, returned as ``[W, B]`` sample indices and
the augment plan, so gathering ``data[idx]`` and applying the plan on the
device reproduces ``sample_round``'s batch. ``epoch`` and
``epoch_indices`` yield an epoch's rounds in order, and ``prefetch`` runs
such an iterator in a background thread a few items ahead (the runner's
round source at ``pipeline_depth 0``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from commefficient_tpu_torch import native
from commefficient_tpu_torch.data.fed_dataset import FedDataset

Batch = Dict[str, np.ndarray]


class FedSampler:
    def __init__(self, dataset: FedDataset, *, num_workers: int,
                 local_batch_size: int, seed: int = 42, augment=None):
        if dataset.num_clients < num_workers:
            raise ValueError("need num_clients >= num_workers")
        if augment is not None and not hasattr(augment, "plan"):
            raise ValueError(
                "augment must be plan-based (data.cifar.CifarAugment, "
                "data.imagenet.ImageNetAugment) or None"
            )
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.seed = seed
        self.augment = augment
        x = dataset.data.get("x")
        self._fusable = (
            all(isinstance(v, np.ndarray) for v in dataset.data.values())
            and (augment is None or (isinstance(x, np.ndarray) and x.ndim == 4
                                     and x.dtype in (np.float32, np.uint8))))

    @property
    def fusable(self) -> bool:
        """True when a round is one index gather (+ plan) over numpy
        arrays, so it can also be driven from device-resident data through
        ``sample_round_indices`` (the reference's gate)."""
        return self._fusable

    def steps_per_epoch(self) -> int:
        """Rounds per epoch: one epoch visits ~the whole dataset."""
        per_round = self.num_workers * self.local_batch_size
        return max(1, len(self.dataset) // per_round)

    def _draw(self, round_idx: int):
        """(rng after the draws, clients [W], flat sample indices [W*B]
        int64): the draws every form of a round starts with."""
        rng = np.random.default_rng((self.seed, round_idx))
        clients = rng.choice(self.dataset.num_clients, size=self.num_workers,
                             replace=False)
        flat = np.concatenate([
            self.dataset.client_batch_indices(int(c), self.local_batch_size,
                                              rng)
            for c in clients
        ]).astype(np.int64)
        return rng, clients, flat

    def sample_round(self, round_idx: int, alloc: Optional[Callable] = None
                     ) -> Tuple[np.ndarray, Batch]:
        """(client_ids [W] int32, batch {k: [W, B, ...]}) for one round.
        ``alloc(key, shape, dtype)``, when given, returns the buffer the
        native gather writes key's ``[W*B, ...]`` array into (the staging
        ring's pinned memory); without the library the arrays are numpy's
        own."""
        rng, clients, flat = self._draw(round_idx)
        W, B = self.num_workers, self.local_batch_size
        fused = self._fusable and native.available()
        batch: Batch = {}
        for k, v in self.dataset.data.items():
            buf = (alloc(k, (W * B,) + v.shape[1:], v.dtype)
                   if fused and alloc is not None else None)
            if k == "x" and self.augment is not None:
                p = self.augment.plan(rng, W * B, v.shape[1], v.shape[2])
                out = (self.augment.gather_apply(v, flat, p, out=buf)
                       if fused else None)
                if out is None:
                    out = self.augment.apply(np.ascontiguousarray(v[flat]), p)
            else:
                out = native.gather_rows(v, flat, out=buf) if fused else None
                if out is None:
                    out = v[flat]
            batch[k] = out.reshape((W, B) + out.shape[1:])
        return clients.astype(np.int32), batch

    def sample_round_indices(self, round_idx: int):
        """(client_ids [W] int32, idx [W, B] int32, plan): ``sample_round``
        as indices and the augment plan's arrays (``()`` without an
        augment), from the identical draw sequence."""
        # the indices go out as int32
        if len(self.dataset) >= 2**31:
            raise OverflowError(
                f"dataset has {len(self.dataset)} rows; the device-resident "
                "index path ships int32 sample indices — use the host batch "
                "path (--device_data false) for datasets >= 2^31 rows")
        rng, clients, flat = self._draw(round_idx)
        W, B = self.num_workers, self.local_batch_size
        plan = ()
        if self.augment is not None:
            x = self.dataset.data["x"]
            plan = tuple(self.augment.plan(rng, W * B, x.shape[1],
                                           x.shape[2]))
        return (clients.astype(np.int32), flat.astype(np.int32).reshape(W, B),
                plan)

    def epoch(self, epoch_idx: int):
        """``sample_round`` for each round of epoch ``epoch_idx``, in order."""
        steps = self.steps_per_epoch()
        for s in range(epoch_idx * steps, (epoch_idx + 1) * steps):
            yield self.sample_round(s)

    def epoch_indices(self, epoch_idx: int):
        """``sample_round_indices`` for each round of epoch ``epoch_idx``."""
        steps = self.steps_per_epoch()
        for s in range(epoch_idx * steps, (epoch_idx + 1) * steps):
            yield self.sample_round_indices(s)


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Run ``it`` in a background thread, ``depth`` items ahead.

    The host batch assembly (the native gather, which releases the GIL, or
    numpy, which releases it inside its vectorized loops) then overlaps the
    round the consumer launches. An exception in the producer re-raises at
    the consumer. When the consumer stops early (an exception mid-epoch, a
    ``max_rounds`` cut, the generator closed), the queue is drained and the
    stop flag set, so the producer exits after the item it is drawing
    instead of blocking on the full queue; closing the generator joins
    it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put(item) or stop.is_set():
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            put(e)

    t = threading.Thread(target=run, name="sampler-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:  # wake a producer blocked on the full queue at once
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)  # at most the item it is drawing

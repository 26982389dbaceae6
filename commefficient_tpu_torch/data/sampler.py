"""FedSampler — per-round client participation and batch assembly.

The port's own copy of the numpy path of
``commefficient_tpu/data/sampler.py``: each round draws ``num_workers``
distinct clients and one flat ``[W*B]`` gather (+ plan-based augmentation)
from ``default_rng((seed, round))``, the same draw sequence as the
reference, so the same seed gives the same batches in both packages. The
reference's native C++ gather is not ported (its output is pinned equal to
this numpy path in the reference's own tests).

``sample_round_indices`` is the index-only form for the device-resident
training set: the same draws, returned as ``[W, B]`` sample indices and
the augment plan, so gathering ``data[idx]`` and applying the plan on the
device reproduces ``sample_round``'s batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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

    def sample_round(self, round_idx: int) -> Tuple[np.ndarray, Batch]:
        """(client_ids [W] int32, batch {k: [W, B, ...]}) for one round."""
        rng, clients, flat = self._draw(round_idx)
        W, B = self.num_workers, self.local_batch_size
        batch: Batch = {}
        for k, v in self.dataset.data.items():
            if k == "x" and self.augment is not None:
                p = self.augment.plan(rng, W * B, v.shape[1], v.shape[2])
                out = self.augment.apply(np.ascontiguousarray(v[flat]), p)
            else:
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

"""FedSampler — per-round client participation and batch assembly.

The port's own copy of the numpy path of
``commefficient_tpu/data/sampler.py``: each round draws ``num_workers``
distinct clients and one flat ``[W*B]`` gather (+ plan-based augmentation)
from ``default_rng((seed, round))``, the same draw sequence as the
reference, so the same seed gives the same batches in both packages. The
reference's native C++ gather is not ported (its output is pinned equal to
this numpy path in the reference's own tests).
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
                "augment must be plan-based (data.cifar.CifarAugment) or None"
            )
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.seed = seed
        self.augment = augment

    def steps_per_epoch(self) -> int:
        """Rounds per epoch: one epoch visits ~the whole dataset."""
        per_round = self.num_workers * self.local_batch_size
        return max(1, len(self.dataset) // per_round)

    def sample_round(self, round_idx: int) -> Tuple[np.ndarray, Batch]:
        """(client_ids [W] int32, batch {k: [W, B, ...]}) for one round."""
        rng = np.random.default_rng((self.seed, round_idx))
        clients = rng.choice(self.dataset.num_clients, size=self.num_workers,
                             replace=False)
        W, B = self.num_workers, self.local_batch_size
        flat = np.concatenate([
            self.dataset.client_batch_indices(int(c), B, rng)
            for c in clients
        ]).astype(np.int64)
        batch: Batch = {}
        for k, v in self.dataset.data.items():
            if k == "x" and self.augment is not None:
                p = self.augment.plan(rng, W * B, v.shape[1], v.shape[2])
                out = self.augment.apply(np.ascontiguousarray(v[flat]), p)
            else:
                out = v[flat]
            batch[k] = out.reshape((W, B) + out.shape[1:])
        return clients.astype(np.int32), batch

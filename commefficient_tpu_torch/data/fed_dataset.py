"""FedDataset — a classic dataset partitioned over virtual clients.

The port's own copy of ``commefficient_tpu/data/fed_dataset.py``: the same
numpy draws from the same seed, so both packages give every client the same
indices (pinned by tests/test_torch_round.py). Host-side numpy throughout.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class FedDataset:
    """In-memory dataset partitioned over ``num_clients`` virtual clients,
    IID (global shuffle, even split) or pathologically non-IID (sorted by
    label, ``SHARDS_PER_CLIENT`` contiguous label shards each), or, for a
    naturally federated dataset (PersonaChat: one persona a client), by
    an explicit ``client_indices`` map. Arrays may have any trailing
    shape (PersonaChat's ``[N, candidates, T]``)."""

    SHARDS_PER_CLIENT = 2

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        num_clients: int,
        *,
        iid: bool = True,
        seed: int = 42,
        client_indices: Optional[List[np.ndarray]] = None,
    ):
        lengths = {k: len(v) for k, v in data.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged data arrays: {lengths}")
        self.data = data
        self.n = next(iter(lengths.values()))
        self.num_clients = num_clients
        self.seed = seed
        if client_indices is not None:
            self.client_indices = [np.asarray(ix, np.int64)
                                   for ix in client_indices]
            self.num_clients = len(self.client_indices)
        else:
            self.client_indices = (self._iid_split() if iid
                                   else self._non_iid_split())

    def _iid_split(self) -> List[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(self.n)
        return [np.sort(s) for s in np.array_split(perm, self.num_clients)]

    def _non_iid_split(self) -> List[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        labels = np.asarray(self.data["y"])
        shards_per_client = self.SHARDS_PER_CLIENT
        order = np.argsort(labels, kind="stable")
        n_shards = self.num_clients * shards_per_client
        shards = np.array_split(order, n_shards)
        shard_perm = rng.permutation(n_shards)
        out = []
        for c in range(self.num_clients):
            take = shard_perm[c * shards_per_client:
                              (c + 1) * shards_per_client]
            out.append(np.sort(np.concatenate([shards[s] for s in take])))
        return out

    def __len__(self) -> int:
        return self.n

    def client_batch_indices(self, client_id: int, batch_size: int,
                             rng: np.random.Generator) -> np.ndarray:
        """A batch of GLOBAL indices from one client's shard (with
        replacement iff the shard is smaller than the batch)."""
        ix = self.client_indices[client_id]
        return rng.choice(ix, size=batch_size, replace=len(ix) < batch_size)

    def eval_batches(self, batch_size: int):
        """Sequential batches over the whole set; the final partial batch is
        padded by repeating its last row and carries ``_valid`` rows."""
        for start in range(0, self.n, batch_size):
            ix = np.arange(start, min(start + batch_size, self.n))
            valid = len(ix)
            if valid < batch_size:
                ix = np.concatenate([ix, np.full(batch_size - valid, ix[-1])])
            batch = {k: v[ix] for k, v in self.data.items()}
            batch["_valid"] = np.asarray(valid, np.int32)
            yield batch

"""FedEMNIST (FEMNIST) — naturally non-IID: each handwriting user is a
client. The port's own copy of ``commefficient_tpu/data/emnist.py``, the
same numpy draws from the same seed.

LEAF-preprocessed FEMNIST (62 classes, 28x28 grayscale, one client per
LEAF "user") is read from ``all_data*.json`` shards under
``dataset_dir/femnist`` when present; otherwise a synthetic non-IID
stand-in: class prototypes shifted by a per-user style, each user writing
a subset of 5-14 classes, and ``label_noise`` of each user's labels
redrawn from the user's own classes, so the accuracy ceiling sits near
``(1 - p) + p * E[1/|C|]`` (~0.947 at p = 0.06). The noise draws come from
a separate ``(seed, EMNIST_NOISE_STREAM)`` generator, so ``label_noise=0``
reproduces the noise-free draw and ``x`` is the same at every setting.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset

NUM_CLASSES = 62
# the label-noise generator's stream tag: (seed, EMNIST_NOISE_STREAM)
EMNIST_NOISE_STREAM = 0x1AB31


def _load_leaf(root: str) -> Tuple[dict, list]:
    """Every user of every ``all_data*.json`` shard under ``root`` (sorted
    paths, the file's user order): ``{"x": [N, 28, 28, 1] f32, "y": [N]
    i32}`` and each user's global indices."""
    xs, ys, client_indices = [], [], []
    offset = 0
    for path in sorted(glob.glob(os.path.join(root, "**", "all_data*.json"),
                                 recursive=True)):
        with open(path) as f:
            blob = json.load(f)
        for user in blob["users"]:
            ud = blob["user_data"][user]
            x = np.asarray(ud["x"], np.float32).reshape(-1, 28, 28, 1)
            y = np.asarray(ud["y"], np.int32)
            xs.append(x)
            ys.append(y)
            client_indices.append(np.arange(offset, offset + len(y)))
            offset += len(y)
    return {"x": np.concatenate(xs), "y": np.concatenate(ys)}, client_indices


def _synthetic_femnist(num_clients: int, per_client: int = 120,
                       seed: int = 7, *, label_noise: float = 0.06):
    """The non-IID stand-in (module docstring), draw for draw."""
    rng = np.random.default_rng(seed)
    noise_rng = np.random.default_rng((seed, EMNIST_NOISE_STREAM))
    protos = rng.normal(0, 1, size=(NUM_CLASSES, 28, 28, 1)).astype(
        np.float32)
    xs, ys, client_indices = [], [], []
    offset = 0
    for _ in range(num_clients):
        style = rng.normal(0, 0.5, size=(28, 28, 1)).astype(np.float32)
        classes = rng.choice(NUM_CLASSES, size=rng.integers(5, 15),
                             replace=False)
        y_true = rng.choice(classes, size=per_client).astype(np.int32)
        x = protos[y_true] + style + rng.normal(
            0, 0.3, size=(per_client, 28, 28, 1)).astype(np.float32)
        y = y_true.copy()
        if label_noise > 0:
            flip = noise_rng.random(per_client) < label_noise
            y[flip] = noise_rng.choice(classes, size=int(flip.sum())).astype(
                np.int32)
        xs.append(x.astype(np.float32))
        ys.append(y)
        client_indices.append(np.arange(offset, offset + per_client))
        offset += per_client
    return {"x": np.concatenate(xs), "y": np.concatenate(ys)}, client_indices


def load_fed_emnist(dataset_dir: str, *, num_clients: int, seed: int = 42,
                    label_noise: float = 0.06,
                    ) -> Tuple[FedDataset, FedDataset, bool]:
    """(train, test, is_real): the first 90% of each client's samples
    train (its ``client_indices``), the rest pooled into one IID test set.
    ``label_noise`` reaches the stand-in only."""
    root = os.path.join(dataset_dir, "femnist")
    real = bool(glob.glob(os.path.join(root, "**", "all_data*.json"),
                          recursive=True))
    if real:
        data, client_indices = _load_leaf(root)
    else:
        data, client_indices = _synthetic_femnist(
            num_clients, seed=seed, label_noise=label_noise)
    train_ix, test_ix = [], []
    for ix in client_indices:
        cut = max(1, int(0.9 * len(ix)))
        train_ix.append(ix[:cut])
        test_ix.append(ix[cut:])
    train = FedDataset(data, len(client_indices), client_indices=train_ix,
                       seed=seed)
    test_all = np.concatenate(test_ix)
    test = FedDataset({k: v[test_all] for k, v in data.items()}, 1,
                      iid=True, seed=seed)
    return train, test, real

"""Which samples each round trains on, worked out again from the seed:
round ``r`` draws its W distinct clients and then each client's B
samples (with replacement only where the client holds fewer than B)
from ``numpy.random.default_rng((seed, r))``, and, for images, the
augmentation's draws after them: crop offsets into the reflect-padded
image, the horizontal flip, and the cutout's centre, in that order.
The augmentation is pad 4, crop, flip, then an 8 x 8 cutout filled with
the byte value of CIFAR-10's channel means."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

PAD, CUT_HALF = 4, 4
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def round_batch(data: Dict[str, np.ndarray], client_indices: List[np.ndarray],
                seed: int, r: int, W: int, B: int, augment: bool
                ) -> Dict[str, np.ndarray]:
    """Round ``r``'s batch, ``{key: [W, B, ...]}``."""
    rng = np.random.default_rng((int(seed), int(r)))
    clients = rng.choice(len(client_indices), size=W, replace=False)
    flat = np.concatenate([
        rng.choice(client_indices[c], size=B,
                   replace=len(client_indices[c]) < B)
        for c in clients]).astype(np.int64)
    out = {}
    for k, v in data.items():
        rows = v[flat]
        if k == "x" and augment:
            rows = _augment(rows, rng)
        out[k] = rows.reshape((W, B) + rows.shape[1:])
    return out


def _augment(x: np.ndarray, rng: np.random.Generator,
             fill: Optional[np.ndarray] = None) -> np.ndarray:
    n, h, w, c = x.shape
    ys = rng.integers(0, 2 * PAD + 1, size=n)
    xs = rng.integers(0, 2 * PAD + 1, size=n)
    flips = rng.random(n) < 0.5
    cys = rng.integers(0, h, size=n)
    cxs = rng.integers(0, w, size=n)
    padded = np.pad(x, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)),
                    mode="reflect")
    out = np.empty_like(x)
    for i in range(n):
        img = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        if flips[i]:
            img = img[:, ::-1]
        out[i] = img
    if fill is None:
        fill = np.round(255.0 * CIFAR10_MEAN).astype(np.uint8)
    for i in range(n):
        out[i, max(cys[i] - CUT_HALF, 0):cys[i] + CUT_HALF,
            max(cxs[i] - CUT_HALF, 0):cxs[i] + CUT_HALF] = fill
    return out

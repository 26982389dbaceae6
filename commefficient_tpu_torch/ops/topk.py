"""Top-k sparsification (the reference's ``ops/topk.py``, exact path).

``torch.topk`` on |v| with ``jax.lax.top_k``'s tie rule: among equal
magnitudes the lower index is taken, and the result is ordered by
descending magnitude, lower index first. ``torch.topk`` alone breaks ties
in no stated order, which would let the two packages select different
coordinates when magnitudes tie at the k-th place (ROADMAP C hazard 3).
The reference leaves top-k to XLA; it is not a Pallas kernel.
"""

from __future__ import annotations

import torch


def topk_sparsify(v: torch.Tensor, k: int):
    """(values [k], indices [k]) of the k largest-|.| entries of flat v."""
    mag = torch.abs(v)
    t = torch.topk(mag, k, sorted=False).values.min()
    above = torch.nonzero(mag > t).squeeze(1)
    ties = torch.nonzero(mag == t).squeeze(1)[: k - above.numel()]
    idx = torch.cat([above, ties])
    # descending magnitude, lower index first among equals (idx ascends
    # within each group, and the sort is stable)
    idx = idx[torch.sort(mag[idx], descending=True, stable=True).indices]
    return v[idx], idx


def topk_dense(v: torch.Tensor, k: int) -> torch.Tensor:
    """Dense vector keeping only the top-k entries of v by magnitude."""
    vals, idx = topk_sparsify(v, k)
    out = torch.zeros_like(v)
    out[idx] = vals
    return out

"""(idx, val) pair exchange over the worker group (the reference's
``ops/collectives/sparse_allreduce.py``, its monolithic gather form).

A worker compacts its at-most-k-sparse vector into a fixed-size pair buffer
(``compact_pairs``: int64 indices, ``(0, 0.0)`` padding) and one
``all_gather`` of those buffers gives every rank all ``size * kb`` pairs in
rank order: O(W*k) bytes on the wire instead of a D-sized reduction. A
scatter-add of the gathered pairs then treats the pads as no-ops.
"""

from __future__ import annotations

from typing import Tuple

import torch

from commefficient_tpu_torch.ops.topk import compact_nonzero


def compact_pairs(v: torch.Tensor,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx, val)`` buffer of the first ``capacity`` nonzeros of [n]
    ``v``: the exchange's one spelling of the contract documented on
    ``ops.topk.compact_nonzero``."""
    return compact_nonzero(v, capacity)


def all_gather_pairs(idx: torch.Tensor, val: torch.Tensor,
                     group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's [kb] pair buffer concatenated in rank order:
    replicated ``[size * kb]`` buffers on every rank."""
    return group.all_gather(idx), group.all_gather(val)

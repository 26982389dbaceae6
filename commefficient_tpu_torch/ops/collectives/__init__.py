"""Sparse collective primitives: (idx, val) pair exchange over the worker
group (see ``sparse_allreduce``)."""

from commefficient_tpu_torch.ops.collectives.sparse_allreduce import (
    all_gather_pairs,
    compact_pairs,
)

__all__ = ["all_gather_pairs", "compact_pairs"]

"""Sparse collective primitives: (idx, val) pair exchange over the worker
group (see ``sparse_allreduce``)."""

from commefficient_tpu_torch.ops.collectives.sparse_allreduce import (
    OVERLAP_SEGMENTS,
    all_gather_pairs,
    compact_pairs,
    psum_segments,
    psum_segments_fused,
    scatter_add_pairs,
    sparse_allreduce,
    sparse_allreduce_sharded,
)

__all__ = ["OVERLAP_SEGMENTS", "all_gather_pairs", "compact_pairs",
           "psum_segments", "psum_segments_fused", "scatter_add_pairs",
           "sparse_allreduce", "sparse_allreduce_sharded"]

"""Kernels-facing ops of the port: CountSketch, top-k, the flat vector."""

from commefficient_tpu_torch.ops.countsketch import (
    CountSketch,
    estimate_all,
    estimate_at,
    estimate_at_range,
    sketch_sparse,
    sketch_vec,
    unsketch,
    unsketch_dense,
    unsketch_sparse,
)
from commefficient_tpu_torch.ops.param_utils import (
    clip_by_global_norm,
    ravel_params,
)
from commefficient_tpu_torch.ops.topk import (
    compact_nonzero,
    topk_dense,
    topk_sparsify,
    topk_threshold_dense,
    topk_threshold_sharded,
)

__all__ = ["CountSketch", "clip_by_global_norm", "compact_nonzero",
           "estimate_all", "estimate_at", "estimate_at_range", "ravel_params",
           "sketch_sparse",
           "sketch_vec", "topk_dense", "topk_sparsify",
           "topk_threshold_dense", "topk_threshold_sharded", "unsketch",
           "unsketch_dense", "unsketch_sparse"]

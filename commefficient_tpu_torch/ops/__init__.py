"""Kernels-facing ops of the port: CountSketch, top-k, the flat vector."""

from commefficient_tpu_torch.ops.countsketch import (
    CountSketch,
    SketchGradTap,
    estimate_all,
    estimate_at,
    estimate_at_range,
    l2_estimate,
    sketch_segment,
    sketch_sparse,
    sketch_vec,
    table_sqnorm_estimate,
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
    mask_out_indices,
    topk_dense,
    topk_sparsify,
    topk_threshold_dense,
    topk_threshold_sharded,
)

__all__ = ["CountSketch", "SketchGradTap", "clip_by_global_norm",
           "compact_nonzero", "estimate_all", "estimate_at",
           "estimate_at_range", "l2_estimate", "mask_out_indices",
           "ravel_params", "sketch_segment", "sketch_sparse", "sketch_vec",
           "table_sqnorm_estimate", "topk_dense", "topk_sparsify",
           "topk_threshold_dense", "topk_threshold_sharded", "unsketch",
           "unsketch_dense", "unsketch_sparse"]

"""Kernels-facing ops of the port: CountSketch, top-k, the flat vector."""

from commefficient_tpu_torch.ops.countsketch import (
    CountSketch,
    estimate_all,
    estimate_at,
    sketch_sparse,
    sketch_vec,
    unsketch,
    unsketch_sparse,
)
from commefficient_tpu_torch.ops.param_utils import (
    clip_by_global_norm,
    ravel_params,
)
from commefficient_tpu_torch.ops.topk import topk_dense, topk_sparsify

__all__ = ["CountSketch", "clip_by_global_norm", "estimate_all",
           "estimate_at", "ravel_params", "sketch_sparse", "sketch_vec",
           "topk_dense", "topk_sparsify", "unsketch", "unsketch_sparse"]

"""Hand-written CUDA kernels of the port (sources in ``csrc/``) and their
wrappers. Importing this package builds nothing; the first kernel launch
does (``build.load_library``)."""

from commefficient_tpu_torch.ops.cuda.countsketch import (
    KERNELS,
    estimate_at,
    estimate_at_range,
    estimate_at_range_torch,
    estimate_at_torch,
    estimate_median,
    estimate_median_torch,
    launch_counts,
    median_rows,
    median_rows_torch,
    reset_launch_counts,
    sketch_rows,
    sketch_rows_torch,
)

__all__ = ["KERNELS", "estimate_at", "estimate_at_range",
           "estimate_at_range_torch", "estimate_at_torch", "estimate_median",
           "estimate_median_torch", "launch_counts", "median_rows",
           "median_rows_torch", "reset_launch_counts", "sketch_rows",
           "sketch_rows_torch"]

"""Compression modes of the port, behind the reference's registry: the
reference's six (``uncompressed``, ``fedavg``, ``sketch``, ``true_topk``,
``local_topk``, ``powersgd``)."""

from commefficient_tpu_torch.compress import (  # noqa: F401  (register)
    dense,
    local_topk,
    powersgd,
    sketch,
    true_topk,
)
from commefficient_tpu_torch.compress.registry import (
    available_modes,
    compressor_class,
    get_compressor,
)

__all__ = ["available_modes", "compressor_class", "get_compressor"]

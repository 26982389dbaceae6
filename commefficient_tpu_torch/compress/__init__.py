"""Compression modes of the port, behind the reference's registry."""

from commefficient_tpu_torch.compress import dense, sketch  # noqa: F401  (register)
from commefficient_tpu_torch.compress.registry import (
    available_modes,
    compressor_class,
    get_compressor,
)

__all__ = ["available_modes", "compressor_class", "get_compressor"]

"""``uncompressed`` — dense aggregate, plain (momentum) SGD: the oracle every
other mode's degenerate settings reduce to."""

from __future__ import annotations

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.compress.registry import register


@register("uncompressed")
class DenseCompressor(Compressor):
    allowed_error_types = ("none",)
    dense_delta = True

    def server_update(self, momentum, error, agg, lr: float):
        rho = self.cfg.virtual_momentum
        if rho > 0:
            m = rho * momentum + agg
            return lr * m, m, error
        return lr * agg, momentum, error

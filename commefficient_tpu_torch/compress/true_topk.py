"""``true_topk`` — server-side top-k of the exact dense aggregate (the
reference's ``compress/true_topk.py``).

Clients transmit dense gradients (uplink D floats); the server runs
momentum and lr-scaled virtual error feedback on dense ``[D]`` vectors and
extracts a top-k update:

    m = rho * m + agg;  e += lr * m;  delta = TopK(e, k);  e -= delta

Without error feedback it extracts ``TopK(m, k)`` and applies it times lr.
The sparse-aggregate and FSDP server paths of the reference wait for
ROADMAP A9 (``Config`` refuses what would reach them).
"""

from __future__ import annotations

import warnings

import torch

from commefficient_tpu_torch.compress.base import KIND_DENSE, Compressor
from commefficient_tpu_torch.compress.registry import register


@register("true_topk")
class TrueTopkCompressor(Compressor):
    allowed_error_types = ("none", "virtual")
    supports_fused_clients = True
    dense_delta = False  # the delta already has <= k nonzeros

    def _dampening_warnings(self, dampen: bool) -> None:
        cfg = self.cfg
        if (cfg.momentum_dampening is None
                and (cfg.virtual_momentum > 0 or cfg.local_momentum > 0)):
            warnings.warn(
                "momentum_dampening=AUTO resolves to False for true_topk "
                "(the reference's four-corner evidence: unmasked 0.8923 vs "
                "masked 0.8595 at tuned lr). The original implementation "
                "masks momentum here — pass momentum_dampening=True "
                "explicitly for its behaviour.")

    def server_state_kinds(self):
        # momentum allocated even at rho = 0: the algebra runs
        # m = rho * m + agg unconditionally, as the reference does
        virtual = self.cfg.error_type == "virtual"
        return (KIND_DENSE, KIND_DENSE if virtual else None)

    def server_update(self, momentum, error, extra, agg, lr: float,
                      step: int):
        cfg = self.cfg
        dampen = self.resolved_dampening()
        m = cfg.virtual_momentum * momentum + agg
        if cfg.error_type == "virtual":
            e = error + lr * m
            update = self.topk(e, cfg.k)
            e = e - update  # the extracted coordinates' error is 0
            if cfg.error_decay != 1.0:
                e = cfg.error_decay * e
            delta = update
        else:
            e = error
            update = self.topk(m, cfg.k)
            delta = lr * update
        if dampen:
            # the mask is the UNSCALED selection's support (lr may be 0)
            m = torch.where(update != 0, 0.0, m)
        return delta, m, e, extra

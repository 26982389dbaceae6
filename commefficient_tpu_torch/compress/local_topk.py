"""``local_topk`` — per-client top-k with per-client (local) error feedback
(the reference's ``compress/local_topk.py``).

Each client sparsifies its own update before it transmits, so the uplink
is 2k floats (index, value pairs); the sparse transmits still sum
linearly, since the selection happens per client, before the sum. The
local error bank accumulates ``lr * u`` (FetchSGD Algorithm 1's lr-scaled
banking, per client), so the server applies the aggregate WITHOUT a second
lr; without error feedback the transmit stays in gradient scale and the
server applies lr.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.compress.dense import _DenseServerMixin
from commefficient_tpu_torch.compress.registry import register


@register("local_topk")
class LocalTopkCompressor(_DenseServerMixin, Compressor):
    allowed_error_types = ("none", "local")
    supports_fused_clients = False  # per-client error and selection
    # the device's summed transmit has <= w_loc * k nonzeros (each client
    # sends <= k), so the aggregate rebuilds exactly from one W*k-pair
    # all_gather: every rank gets the dense sum, the server algebra is
    # untouched, so aggregate='auto' may pick it on more than one device
    supports_sparse_aggregate = True
    sparse_aggregate_in_auto = True
    dense_delta = True
    # mask the local momentum at the transmitted coordinates (acts only
    # with local_momentum > 0)
    default_dampening = True

    @property
    def _transmit_is_scaled(self) -> bool:
        return self.cfg.error_type == "local"

    def client_transmit(self, u, err_row, lr: float):
        cfg = self.cfg
        dampen = self.resolved_dampening()
        local = cfg.error_type == "local"
        e = err_row + lr * u if local else u
        t = self.topk(e, cfg.k)
        new_err = e - t if local else err_row
        new_vel = u
        if dampen and cfg.local_momentum > 0:
            new_vel = torch.where(t != 0, 0.0, u)
        return t, new_vel, new_err

    def upload_floats(self) -> int:
        return 2 * self.cfg.k  # (index, value) pairs

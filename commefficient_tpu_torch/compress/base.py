"""Compressor base class — the protocol every mode implements (the
reference's ``compress/base.py``, the single-device dense-decode subset).

A compressor owns one mode's algebra: what a device encodes before the
aggregate (``device_encode``, LINEAR so the sum of encodings is the
encoding of the sum), and the server's momentum/error update that extracts
the applied delta (``server_update``). State leaves are dense ``[D]``
vectors or ``[r, c]`` sketch tables, or ``None`` where absent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from commefficient_tpu_torch.ops.countsketch import unsketch
from commefficient_tpu_torch.ops.topk import topk_dense

KIND_DENSE = "dense"
KIND_TABLE = "table"


class Compressor:
    """One compression mode's full algebra. Subclass + ``@register``."""

    name: str = "?"
    allowed_error_types: Tuple[str, ...] = ("none",)
    needs_sketch_spec: bool = False
    # True -> the applied delta is dense, so do_topk_down's downlink top-k
    # is meaningful (a sketch delta already has <= k nonzeros)
    dense_delta: bool = True

    def __init__(self, cfg, d: int, spec=None):
        self.cfg = cfg
        self.d = d
        self.spec = spec
        self.topk = topk_dense
        self.unsketch = unsketch

    def validate(self) -> None:
        if self.cfg.error_type not in self.allowed_error_types:
            raise NotImplementedError(
                f"(mode={self.name}, error_type={self.cfg.error_type}) is "
                "not a reference-supported combination; allowed: "
                f"{self.allowed_error_types}")

    def server_state_kinds(self) -> Tuple[Optional[str], Optional[str]]:
        """(momentum_kind, error_kind)."""
        return (KIND_DENSE if self.cfg.virtual_momentum > 0 else None, None)

    def init_server_state(self, device):
        """(momentum, error) leaves; ``None`` where absent."""

        def alloc(kind):
            if kind == KIND_DENSE:
                return torch.zeros(self.d, dtype=torch.float32, device=device)
            if kind == KIND_TABLE:
                return torch.zeros(self.spec.table_shape, dtype=torch.float32,
                                   device=device)
            return None

        m_kind, e_kind = self.server_state_kinds()
        return alloc(m_kind), alloc(e_kind)

    def device_encode(self, local_sum: torch.Tensor):
        """LINEAR encode of the device's summed transmit. Default: identity."""
        return local_sum

    def server_update(self, momentum, error, agg, lr: float):
        """``-> (delta, new_momentum, new_error)``; ``delta`` is the APPLIED
        update (``w -= delta``), ``agg`` the averaged encoded aggregate."""
        raise NotImplementedError

    def upload_floats(self) -> int:
        """Per-client uplink floats per round."""
        return self.d

    def upload_bytes_per_float(self) -> int:
        return 4

    def download_floats(self) -> int:
        return self.d

"""Compressor base class — the protocol every mode implements (the
reference's ``compress/base.py``, the subset the port runs).

A compressor owns one mode's algebra:

* per client: the gradient rule (``client_grad``; fedavg runs local SGD
  steps) and the transmit rule after local momentum (``client_transmit``;
  local_topk runs its local error feedback and top-k there);
* per device: what it encodes before the aggregate (``device_encode``,
  LINEAR so the sum of encodings is the encoding of the sum);
* at the server: the momentum/error update that extracts the applied
  delta, ``server_update`` (every device decodes the whole vector) or, for
  modes with ``supports_sharded_decode``, ``server_update_sharded`` (each
  device of the worker group decodes its slice).

Nonlinear steps (top-k, Gram-Schmidt, medians) sit per client before the
device sum or at the server after the aggregate, never between
``device_encode`` and the sum. State leaves are dense ``[D]`` vectors,
``[r, c]`` sketch tables or the compressor's private ``extra`` (powersgd's
warm-start ``Q``), ``None`` where absent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from commefficient_tpu_torch.ops.countsketch import unsketch, unsketch_dense
from commefficient_tpu_torch.ops.topk import topk_dense, topk_threshold_dense

KIND_DENSE = "dense"
KIND_TABLE = "table"


class Compressor:
    """One compression mode's full algebra. Subclass + ``@register``."""

    name: str = "?"
    allowed_error_types: Tuple[str, ...] = ("none",)
    needs_sketch_spec: bool = False
    # True -> the class implements server_update_sharded(), which the
    # round runs when use_sharded_decode() says so
    supports_sharded_decode: bool = False
    # True -> the fused flattened-batch gradient is the same math for this
    # mode (nothing per-client in its transmit rule)
    supports_fused_clients: bool = False
    # True -> the class implements encode_grad_table(), so the fused path
    # may produce its gradient directly as a sketch table
    # (cfg.sketch_fused_bwd; parallel/round.py make_sketch_grad_one)
    supports_fused_backward: bool = False
    # True -> the applied delta is dense, so do_topk_down's downlink top-k
    # is meaningful (a sketch delta already has <= k nonzeros)
    dense_delta: bool = True
    # momentum_dampening=None (AUTO) resolves to this
    default_dampening: bool = False

    def __init__(self, cfg, d: int, spec=None):
        self.cfg = cfg
        self.d = d
        self.spec = spec
        # the top-k selection (cfg.topk_method): exact sorts, threshold
        # bisects a magnitude threshold and keeps at most k
        if cfg.topk_method == "threshold":
            self.topk = topk_threshold_dense
            self.unsketch = unsketch_dense
        else:
            self.topk = topk_dense
            self.unsketch = unsketch
        self._dampen: Optional[bool] = None

    def validate(self) -> None:
        if self.cfg.error_type not in self.allowed_error_types:
            raise NotImplementedError(
                f"(mode={self.name}, error_type={self.cfg.error_type}) is "
                "not a reference-supported combination; allowed: "
                f"{self.allowed_error_types}")

    def resolved_dampening(self) -> bool:
        """``cfg.momentum_dampening`` with AUTO (None) resolved for this
        mode; the mode's warnings are given once, at the first call."""
        if self._dampen is None:
            md = self.cfg.momentum_dampening
            self._dampen = md if md is not None else self.default_dampening
            self._dampening_warnings(self._dampen)
        return self._dampen

    def _dampening_warnings(self, dampen: bool) -> None:
        pass

    def use_sharded_decode(self, workers: int) -> bool:
        """``cfg.sketch_decode`` resolved for a worker group of ``workers``
        devices: ``dense`` (or no capability) -> False, ``sharded`` ->
        True, ``auto`` -> sharded exactly when there is more than one
        worker device and the threshold top-k is selected (the sharded
        selection is built on ``topk_threshold_sharded``; exact top-k keeps
        the dense decode and its tie rule)."""
        if not self.supports_sharded_decode:
            return False
        decode = self.cfg.sketch_decode
        if decode == "dense":
            return False
        if decode == "sharded":
            return True
        return workers > 1 and self.cfg.topk_method == "threshold"

    def server_state_kinds(self) -> Tuple[Optional[str], Optional[str]]:
        """(momentum_kind, error_kind)."""
        return (KIND_DENSE if self.cfg.virtual_momentum > 0 else None, None)

    def init_server_state(self, device):
        """(momentum, error, extra) leaves; ``None`` where absent.
        ``extra`` is compressor-private warm state (powersgd's Q)."""

        def alloc(kind):
            if kind == KIND_DENSE:
                return torch.zeros(self.d, dtype=torch.float32, device=device)
            if kind == KIND_TABLE:  # in the spec's storage type
                return torch.zeros(self.spec.table_shape,
                                   dtype=self.spec.table_dtype, device=device)
            return None

        m_kind, e_kind = self.server_state_kinds()
        return alloc(m_kind), alloc(e_kind), self.init_extra_state(device)

    def init_extra_state(self, device):
        return None

    def client_lr(self, lr: float, device):
        """The lr the client rules take, made once before the clients run
        (outside the batched step). Default: the round's lr; fedavg: its
        local lr as an f32 tensor."""
        return lr

    def client_noise(self, draw, key, batch):
        """The client's DP noise for ``client_grad``: ``draw(key)``, one
        ``[D]`` draw. ``batch`` is the client's."""
        return draw(key)

    def client_grad(self, grad_one, params_vec, batch, noise, lr):
        """Per-client gradient rule: ``-> (g [D], loss, aux)``. Default:
        one gradient pass; fedavg runs its local SGD steps. ``noise`` is
        the client's DP draw (``client_noise``; None without DP), ``lr``
        ``client_lr``'s. Runs under ``torch.func.vmap`` (the batched
        clients): no data-dependent shape, no random draw."""
        return grad_one(params_vec, batch, noise=noise)

    def client_transmit(self, u, err_row, lr: float):
        """Per-client transmit rule after local momentum: ``-> (transmit
        [D], new_vel [D], new_err_row)``. Default: the dense update, the
        client's error row untouched. Runs under ``torch.func.vmap``, as
        ``client_grad``."""
        return u, u, err_row

    def device_encode(self, local_sum: torch.Tensor):
        """LINEAR encode of the device's summed transmit. Default: identity."""
        return local_sum

    def encode_grad_table(self, table: torch.Tensor):
        """``device_encode``'s twin for the sketch-fused backward, whose
        summed transmit arrives already as an f32 table (modes with
        ``supports_fused_backward``)."""
        raise NotImplementedError

    def server_update(self, momentum, error, extra, agg, lr: float,
                      step: int):
        """``-> (delta, new_momentum, new_error, new_extra)``; ``delta`` is
        the APPLIED update (``w -= delta``), ``agg`` the averaged encoded
        aggregate, ``step`` the round counter (powersgd's fresh ``Q``
        without warm start derives from it)."""
        raise NotImplementedError

    def server_update_sharded(self, momentum, error, extra, agg, lr: float,
                              step: int, *, group, d: int):
        """The server update decoded slice by slice over ``group``: every
        input is replicated, each rank extracts from its ``ceil(d/size)``
        coordinates, and the candidates are exchanged. Returns ``(idx,
        val, new_momentum, new_error, new_extra)``, idx/val the replicated
        gathered candidate buffers (``val == 0`` on padding); the round
        applies ``params[idx] -= val``."""
        raise NotImplementedError

    def upload_floats(self) -> int:
        """Per-client uplink floats per round."""
        return self.d

    def upload_bytes_per_float(self) -> int:
        return 4

    def download_floats(self) -> int:
        return self.d

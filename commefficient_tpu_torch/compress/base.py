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
  device of the worker group decodes its slice), or, under sparse
  aggregation with sharded state (true_topk), ``server_update_sparse``;
* under FSDP (``supports_fsdp``): ``fsdp_update``, the server algebra on
  this rank's ``[dp / W]`` slice of params and dense state.

``cfg.aggregate`` resolves per mode and group (``use_sparse_aggregate``):
modes with ``supports_sparse_aggregate`` may exchange (idx, val) pairs in
place of the dense sum over the group (``ops/collectives``).

At ``telemetry_level >= 1`` the round asks the compressor for its
``diag/*`` scalars (``diagnostics`` / ``diagnostics_sparse``; subclasses
override the ``_agg_sqnorm`` / ``_error_sqnorm`` primitives and, for
level 2, ``fidelity`` / ``fidelity_sparse``), and the ledger prices a
fedsim round through ``masked_upload_floats``.

Nonlinear steps (top-k, Gram-Schmidt, medians) sit per client before the
device sum or at the server after the aggregate, never between
``device_encode`` and the sum. State leaves are dense ``[D]`` vectors,
``[r, c]`` sketch tables or the compressor's private ``extra`` (powersgd's
warm-start ``Q``), ``None`` where absent; ``migrate_state`` carries them
across a switch of the control plane's compression ladder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from commefficient_tpu_torch.ops.collectives import OVERLAP_SEGMENTS
from commefficient_tpu_torch.ops.countsketch import unsketch, unsketch_dense
from commefficient_tpu_torch.ops.topk import topk_dense, topk_threshold_dense

KIND_DENSE = "dense"
KIND_TABLE = "table"


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """``sum(x * x)`` of an f32 tensor as a 0-d tensor, in one pass and
    with no temporary of x's size."""
    flat = x.reshape(-1)
    return torch.dot(flat, flat)


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
    # True -> the class implements fsdp_update(); False -> the FSDP round
    # refuses the mode (validate_fsdp)
    supports_fsdp: bool = False
    # True -> the aggregation may ride the sparse pair exchange
    # (ops/collectives): the transmit (or the server's candidate set) is
    # <= O(W*k)-sparse. Resolved by use_sparse_aggregate()
    supports_sparse_aggregate: bool = False
    # True -> aggregate='auto' may resolve to sparse on more than one
    # device (only where sparse changes neither the state's shapes nor the
    # server's algebra: local_topk)
    sparse_aggregate_in_auto: bool = False
    # True -> under sparse aggregation the dense server momentum/error are
    # SHARDED over the group, each rank holding its [padded_dim / W] slice
    # (true_topk: reduce-scatter aggregate, sharded selection)
    sparse_aggregate_shards_state: bool = False
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
        # bisects a magnitude threshold and keeps at most k; approx is the
        # reference's lax.approx_max_k, which off a TPU is the exact
        # selection (ops/topk.py), and so it runs the exact one here
        if cfg.topk_method == "threshold":
            self.topk = topk_threshold_dense
            self.unsketch = unsketch_dense
        else:
            self.topk = topk_dense
            self.unsketch = unsketch
        self._dampen: Optional[bool] = None

    @property
    def overlap_segments(self) -> Optional[int]:
        """``None`` (monolithic collectives) or the number of segments the
        layerwise overlap's pair gathers split into
        (``cfg.overlap_collectives='layerwise'``): pure data movement,
        bit-equal to the monolithic gather."""
        if self.cfg.overlap_collectives == "layerwise":
            return OVERLAP_SEGMENTS
        return None

    def validate(self) -> None:
        if self.cfg.error_type not in self.allowed_error_types:
            raise NotImplementedError(
                f"(mode={self.name}, error_type={self.cfg.error_type}) is "
                "not a reference-supported combination; allowed: "
                f"{self.allowed_error_types}")

    def validate_fsdp(self) -> None:
        """FSDP's constraints for this mode; the base refusal names the
        knob that addresses a client-state mode's memory wall instead."""
        if not self.supports_fsdp:
            raise NotImplementedError(
                "fsdp supports server-state modes (uncompressed/true_topk/"
                f"sketch); mode={self.name} keeps per-client "
                "[num_clients, D] state — use offload_client_state for "
                "that memory wall")

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

    def use_sparse_aggregate(self, workers: int) -> bool:
        """``cfg.aggregate`` resolved for a worker group of ``workers``
        devices: ``dense`` (or no capability) -> False, ``sparse`` -> True
        (Config validated the combination), ``auto`` -> sparse exactly
        when the pair exchange can win and changes results only by f32
        summation order: more than one device, the threshold top-k, and a
        mode that opts into auto (``sparse_aggregate_in_auto``)."""
        if not self.supports_sparse_aggregate:
            return False
        agg = self.cfg.aggregate
        if agg == "dense":
            return False
        if agg == "sparse":
            return True
        return (self.sparse_aggregate_in_auto and workers > 1
                and self.cfg.topk_method == "threshold")

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
                      step: int, draw: Optional[torch.Tensor] = None):
        """``-> (delta, new_momentum, new_error, new_extra)``; ``delta`` is
        the APPLIED update (``w -= delta``), ``agg`` the averaged encoded
        aggregate, ``step`` the round counter, ``draw`` the round's
        ``round_draw(step)`` on the device (None for a mode that draws
        nothing)."""
        raise NotImplementedError

    def round_draw(self, step: int) -> Optional[torch.Tensor]:
        """Round ``step``'s host draw for the server step (a CPU tensor),
        or None when the mode draws nothing (powersgd's fresh ``Q``
        without the warm start is the one draw). The caller makes it
        before the round and passes it as ``server_update(..., draw=)``:
        the per-round path a round at a time, the scan engine a block's
        at once before the replay, so no graph freezes a draw."""
        return None

    def server_update_sharded(self, momentum, error, extra, agg, lr: float,
                              step: int, *, group, d: int):
        """The server update decoded slice by slice over ``group``: every
        input is replicated, each rank extracts from its ``ceil(d/size)``
        coordinates, and the candidates are exchanged. Returns ``(idx,
        val, new_momentum, new_error, new_extra)``, idx/val the replicated
        gathered candidate buffers (``val == 0`` on padding); the round
        applies ``params[idx] -= val``."""
        raise NotImplementedError

    def server_update_sparse(self, momentum, error, extra, agg_sh,
                             lr: float, step: int, *, group, d: int):
        """The server update under sparse aggregation with SHARDED state
        (``sparse_aggregate_shards_state``): ``momentum``, ``error`` and
        ``agg_sh`` are this rank's ``[padded_dim / W]`` slices (``agg_sh``
        from the reduce-scattered transmit sum). Returns ``(idx, val,
        new_momentum_sh, new_error_sh, new_extra)``, idx/val the gathered
        candidate buffers (``val == 0`` on padding) that the round applies
        as ``params[idx] -= val``."""
        raise NotImplementedError

    def fsdp_update(self, p_sh, m_in, e_in, local, lr: float, *, group,
                    W: int, d: int, dp: int, S: int):
        """The FSDP round's server step after the gradient: ``local`` is
        this rank's dense transmit sum ``[d]``, ``p_sh`` and the dense
        state ``[S] = [dp / size]`` slices. Returns ``(new_p_sh,
        new_momentum, new_error, agg)``, ``agg`` the averaged aggregate
        the step built (this rank's reduce-scattered ``[S]`` slice, or the
        summed ``[r, c]`` table), which the diagnostics read. Only classes
        with ``supports_fsdp`` implement it."""
        raise NotImplementedError

    # -- telemetry (telemetry/diagnostics.py) -------------------------------
    def diagnostics(self, level: int, *, agg, delta, momentum, error, extra,
                    new_momentum, new_error, lr, group=None) -> dict:
        """The round's diagnostic scalars, keyed without the ``diag/``
        prefix, for the dense decode: ``agg`` the averaged aggregate in
        this mode's encoded domain (``[D]``, or the ``[r, c]`` table),
        ``delta`` the applied update, ``momentum``/``error``/``extra`` the
        pre-update leaves, ``new_momentum``/``new_error`` what the server
        update returned. ``group`` is given when ``agg`` and the error
        bank are this rank's slices: their squared norms are then summed
        over it in one collective."""
        return self._norm_diagnostics(
            level, agg=agg, new_error=new_error, update_sqnorm=sqnorm(delta),
            group=group, fidelity_fn=lambda: self.fidelity(
                agg=agg, delta=delta, momentum=momentum, error=error,
                extra=extra, new_momentum=new_momentum, lr=lr))

    def _norm_diagnostics(self, level, *, agg, new_error, update_sqnorm,
                          fidelity_fn, group=None) -> dict:
        """The scaffold both decodes share: only how the update's squared
        norm and the fidelity come about differs between them."""
        agg_sq = self._agg_sqnorm(agg)
        ef_sq = self._error_sqnorm(new_error)
        if group is not None:  # sharded slices: one sum over the group
            summed = group.all_reduce_sum(torch.stack(
                [agg_sq] + ([] if ef_sq is None else [ef_sq])))
            agg_sq = summed[0]
            ef_sq = None if ef_sq is None else summed[1]
        d = {"grad_norm": torch.sqrt(agg_sq),
             "update_norm": torch.sqrt(update_sqnorm)}
        if ef_sq is not None:
            # the one server bank: mean == max (local error reports its
            # participant rows in round_diagnostics instead)
            d["ef_residual_norm"] = torch.sqrt(ef_sq)
            d["ef_residual_max"] = d["ef_residual_norm"]
        if level >= 2:
            d.update(fidelity_fn())
        return d

    def diagnostics_sparse(self, level: int, *, agg, idx, val, momentum,
                           error, extra, new_momentum, new_error, lr,
                           group=None) -> dict:
        """``diagnostics`` for a round whose update is the gathered
        ``(idx, val)`` candidates (``val == 0`` on padding): the update's
        squared norm sums the candidate values, and level 2 goes through
        ``fidelity_sparse``."""
        return self._norm_diagnostics(
            level, agg=agg, new_error=new_error, update_sqnorm=sqnorm(val),
            group=group,
            fidelity_fn=lambda: self.fidelity_sparse(idx=idx, val=val,
                                                     lr=lr))

    def _agg_sqnorm(self, agg):
        """Squared L2 norm of the averaged aggregate (dense here)."""
        return sqnorm(agg)

    def _error_sqnorm(self, error):
        """Squared L2 norm of the server error bank, or None when the mode
        keeps none."""
        return None if error is None else sqnorm(error)

    def fidelity(self, *, agg, delta, momentum, error, extra, new_momentum,
                 lr) -> dict:
        """Level-2 fidelity scalars of the dense decode; the exact modes
        report none."""
        return {}

    def fidelity_sparse(self, *, idx, val, lr) -> dict:
        """Level-2 fidelity scalars from the ``(idx, val)`` update; the
        exact modes report none."""
        return {}

    # -- rung migration (the control/ compression ladder) ---------------------
    def migrate_state(self, new: "Compressor", momentum, error, extra):
        """Carry the compressor's ``FedState`` leaves across a ladder-rung
        switch: ``self`` is the OLD rung's compressor, ``new`` the one the
        next round dispatches (the same mode; a rung differs only in
        ``k``, ``num_cols`` or ``powersgd_rank``). Returns ``(momentum,
        error, extra)`` shaped for ``new``; runs eagerly at the host's
        round boundary.

        The base is the identity: for every dense-state mode a ``k``
        change alters only the extraction's sparsity, and the ``[D]``
        momentum and error (and absent ``None`` leaves) do not depend on
        the rung, so the switch passes the same tensors through. Modes
        whose state layout depends on a ladder field override it (sketch
        re-sketches its tables across column geometries; powersgd pads or
        truncates its warm ``Q`` across ranks)."""
        return momentum, error, extra

    def warm_migration(self, device) -> None:
        """Run, once, the torch ops a ``migrate_state`` out of this rung
        launches besides the CountSketch kernels, on scratch tensors on
        ``device``, so a first switch does not pay torch's loading of
        their kernels. The base's migration runs none."""

    def upload_floats(self) -> int:
        """Per-client uplink floats per round."""
        return self.d

    def upload_bytes_per_float(self) -> int:
        return 4

    def download_floats(self) -> int:
        return self.d

    def masked_upload_floats(self, live_clients: int) -> int:
        """Uplink floats of a fedsim round in which ``live_clients``
        transmitted: every mode's payload is the same whoever takes part,
        so it is linear in the live count (the ledger's masked invariant
        rests on this hook; a mode whose payload depends on the cohort
        overrides it)."""
        return int(live_clients) * self.upload_floats()

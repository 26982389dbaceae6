"""In-round health diagnostics (the port's copy of the reference's
``telemetry/diagnostics.py``).

The round builders (``parallel/round.py``, ``parallel/fsdp.py``) call
these after the update is applied, only at ``cfg.telemetry_level >= 1``:
at level 0 nothing here runs, so the round launches what it launched
before. Every scalar stays a 0-d tensor on the round's device and rides
the round's metrics to the deferred drain (``utils/logging.py``
``drain_round_metrics``): nothing here reads a value back.

The ``diag/*`` scalars:

  diag/grad_norm         L2 norm of the averaged aggregate: exact for the
                         dense-transmit modes, the AMS estimate (median
                         over rows of the row sums of squares, K3 on the
                         card) of the ``[r, c]`` table in sketch mode.
  diag/update_norm       L2 norm of the applied update (w -= delta).
  diag/ef_residual_norm  L2 norm of the error feedback after the round's
                         extraction: the server bank (AMS-estimated when
                         sketched), or the MEAN over the round's W
                         participant rows for local error.
  diag/ef_residual_max   the max over those rows; the norm itself for the
                         one server bank.
  diag/nonfinite         1.0 iff the loss, a norm above or the new params
                         hold a NaN or an Inf: the flight recorder's
                         divergence trigger.
  diag/<fidelity>        level 2 only, per mode (``Compressor.fidelity``):
                         sketch_est_rel_err, powersgd_recon_rel_err.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from commefficient_tpu_torch.ops.countsketch import (  # noqa: F401
    table_sqnorm_estimate,
)


def all_finite(v: torch.Tensor) -> torch.Tensor:
    """0-d bool: every element of ``v`` is finite. One read of ``v``: its
    min and max (``aminmax`` propagates a NaN, and an Inf is an extreme)
    are finite exactly when every element is, where ``isfinite(v).all()``
    runs several elementwise passes and a ``[D]`` temporary."""
    lo, hi = torch.aminmax(v)
    return torch.isfinite(lo) & torch.isfinite(hi)


def nonfinite_sentinel(scalars, vecs=()) -> torch.Tensor:
    """1.0 iff any scalar or any element of a vector is NaN or Inf, else
    0.0, as a 0-d f32 tensor on the inputs' device."""
    # on the round's path every scalar is a 0-d device tensor, for which
    # as_tensor is the identity (the block-program check in
    # tests/test_torch_scan_engine.py holds it)
    # lint: allow[traced-purity] identity on the round's 0-d tensors
    flags = [torch.isfinite(torch.as_tensor(s)).reshape(()) for s in scalars]
    flags += [all_finite(v) for v in vecs]
    dev = flags[0].device
    ok = torch.stack([f.to(dev) for f in flags]).all()
    return 1.0 - ok.to(torch.float32)


def _seal(diag: dict, loss, new_params) -> dict:
    """The shared tail of both drivers: the sentinel and the ``diag/``
    prefix."""
    vecs = () if new_params is None else (new_params,)
    diag["nonfinite"] = nonfinite_sentinel([loss, *diag.values()], vecs)
    return {f"diag/{k}": v for k, v in diag.items()}


def round_diagnostics(cfg, comp, *, agg: Any, delta: torch.Tensor,
                      new_params: torch.Tensor, loss, lr, momentum: Any,
                      error: Any, extra: Any, new_momentum: Any,
                      new_error: Any,
                      client_err_rows: Optional[torch.Tensor] = None,
                      group=None) -> dict:
    """The round's ``{"diag/...": 0-d tensor}`` for the dense decode
    (``{}`` below level 1). ``momentum``/``error``/``extra`` are the
    pre-update leaves, ``new_momentum``/``new_error`` what the server
    update returned (powersgd's fidelity reads the round's own momentum
    from it instead of recomputing it); ``client_err_rows`` the whole
    cohort's ``[W, D]`` new error rows under local error feedback, else
    None; ``group`` the worker group when ``agg`` and the error bank are
    this rank's slices (true_topk's sharded state), else None."""
    level = cfg.telemetry_level
    if level < 1:
        return {}
    diag = comp.diagnostics(level, agg=agg, delta=delta, momentum=momentum,
                            error=error, extra=extra,
                            new_momentum=new_momentum, new_error=new_error,
                            lr=lr, group=group)
    if client_err_rows is not None:
        row_norms = torch.linalg.vector_norm(client_err_rows, dim=-1)
        diag["ef_residual_norm"] = torch.mean(row_norms)
        diag["ef_residual_max"] = torch.max(row_norms)
    return _seal(diag, loss, new_params)


def round_diagnostics_sparse(cfg, comp, *, agg: Any, idx: torch.Tensor,
                             val: torch.Tensor, new_params: torch.Tensor,
                             loss, lr, momentum: Any, error: Any, extra: Any,
                             new_momentum: Any, new_error: Any,
                             group=None) -> dict:
    """``round_diagnostics`` for a round whose update is the gathered
    ``(idx, val)`` candidates (``val == 0`` on padding): the sharded
    sketch decode and true_topk's sparse aggregation. No dense delta
    exists: ``update_norm`` sums the candidate values (the ranks own
    disjoint coordinates, so it is exact) and level 2 goes through
    ``Compressor.fidelity_sparse``. Local error never takes this path."""
    level = cfg.telemetry_level
    if level < 1:
        return {}
    diag = comp.diagnostics_sparse(level, agg=agg, idx=idx, val=val,
                                   momentum=momentum, error=error,
                                   extra=extra, new_momentum=new_momentum,
                                   new_error=new_error, lr=lr, group=group)
    return _seal(diag, loss, new_params)

"""The FSDP round: params and dense server state sharded over the worker
group (the reference's ``parallel/fsdp.py``).

The replicated round keeps the ``[D]`` params and, in true_topk, dense
``[D]`` momentum and error on every device. Here each rank holds its
contiguous ``[S] = [padded_dim(D, W) / W]`` slice of every persistent
``[D]`` leaf (D padded with zeros to a multiple of the group's size W):

* params: the round all-gathers the whole vector once for the forward and
  backward (a transient, like the activations), computes its clients'
  gradients, and applies a sliced update;
* dense server momentum and error (uncompressed, true_topk): never whole.
  The gradient sums are reduce-scattered straight into the slices and the
  server algebra runs on them (``Compressor.fsdp_update``);
* sketch: the ``[r, c]`` tables are small and stay whole on every rank;
  what is sliced is the extraction, each rank estimating only its
  coordinate range (K4's range form on the card), the global top-k
  threshold found with scalar collectives, and the error feedback's
  re-sketch summed over the group.

The per-mode algebra lives on the compressors (``fsdp_update``,
``validate_fsdp``); this module owns the frame (gather, gradients, loss
sums, the fedsim masks and renormalization) and the generic constraints
(``validate_fsdp``): modes uncompressed / true_topk / sketch with server
state only, and the threshold top-k. It equals the replicated round up to
f32 summation order (the reduce-scatter sums in another order). At
``telemetry_level >= 1`` the round adds the reference's sharded
diagnostics (``fsdp_diagnostics``), without the level-2 fidelity, as
there. The FSDP round has no sketch-fused backward and no device-resident data
path, as in the reference: its gradient is the dense one of
``make_grad_one``, and its rounds take the host batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from commefficient_tpu_torch.compress.base import (
    KIND_DENSE,
    KIND_TABLE,
    sqnorm,
)
from commefficient_tpu_torch.telemetry.diagnostics import (
    all_finite,
    nonfinite_sentinel,
    table_sqnorm_estimate,
)
from commefficient_tpu_torch.parallel.round import (
    FedState,
    batched_client_transmits,
    client_inputs,
    fused_grad_sum,
    live_scale,
    make_grad_one,
    make_per_client,
    padded_dim,
)


def validate_fsdp(cfg, comp) -> None:
    """The reference's FSDP constraints (``NotImplementedError``, as
    there): the mode's own (``comp.validate_fsdp``), no client state, and
    the threshold top-k."""
    comp.validate_fsdp()
    if cfg.error_type == "local" or cfg.local_momentum > 0:
        raise NotImplementedError(
            "fsdp + local client state: fsdp shards server state, and the "
            "[num_clients, D] client banks stay whole")
    if cfg.offload_client_state:
        raise NotImplementedError("fsdp already shards server state; "
                                  "offload_client_state targets local modes")
    if cfg.topk_method != "threshold":
        raise NotImplementedError(
            "fsdp extraction uses the sharded threshold selection; set "
            "topk_method='threshold'")


def init_fsdp_state(cfg, comp, params_vec: torch.Tensor, group) -> FedState:
    """This rank's FSDP state: its ``[S]`` slice of the padded params and
    of each dense server leaf, the sketch tables whole, no client banks."""
    d = params_vec.numel()
    dp = padded_dim(d, group.size)
    S = dp // group.size
    dev = params_vec.device
    vec = torch.nn.functional.pad(params_vec.to(torch.float32), (0, dp - d))
    lo = group.rank * S

    def alloc(kind):
        if kind == KIND_DENSE:
            return torch.zeros(S, dtype=torch.float32, device=dev)
        if kind == KIND_TABLE:
            return torch.zeros(comp.spec.table_shape,
                               dtype=comp.spec.table_dtype, device=dev)
        return None

    m_kind, e_kind = comp.server_state_kinds()
    return FedState(vec[lo:lo + S].clone(), alloc(m_kind), alloc(e_kind),
                    None, None, 0, None)


def per_chip_state_floats(cfg, comp, d: int, n_shards: int) -> dict:
    """The persistent floats a rank holds under FSDP (about D/W plus the
    whole sketch tables) beside what the replicated round holds (D times
    one plus each dense server leaf)."""
    s = padded_dim(d, n_shards) // n_shards
    spec = comp.spec
    table = spec.table_shape[0] * spec.table_shape[1] if spec else 0
    m_kind, e_kind = comp.server_state_kinds()

    def floats(kind):
        return s if kind == KIND_DENSE else table if kind == KIND_TABLE \
            else 0

    out = {"params": s, "momentum": floats(m_kind), "error": floats(e_kind)}
    out["total"] = sum(out.values())
    out["replicated_equivalent"] = d * (
        1 + (m_kind == KIND_DENSE) + (e_kind == KIND_DENSE)) + table * (
        (m_kind == KIND_TABLE) + (e_kind == KIND_TABLE))
    return out


def fsdp_diagnostics(comp, group, *, agg, p_sh, new_p, new_e, loss) -> dict:
    """The FSDP round's ``diag/*`` scalars from the slices it holds:
    ``grad_norm`` the AMS estimate of the summed table ``fsdp_update``
    built (sketch) or the norm of the reduce-scattered aggregate slices;
    ``update_norm`` and a dense error bank's norm from the slices'
    squared norms; a table bank AMS-estimated; and the ranks' count of
    non-finite param slices ORed into the sentinel. Every sum over the
    group rides ONE all-reduce of a few floats; the tables are whole on
    every rank. No fidelity, as in the reference."""
    _, e_kind = comp.server_state_kinds()
    sliced = {"update": sqnorm(p_sh - new_p),
              "bad": 1.0 - all_finite(new_p).to(torch.float32)}
    if not comp.needs_sketch_spec:
        sliced["grad"] = sqnorm(agg)
    if e_kind == KIND_DENSE:
        sliced["ef"] = sqnorm(new_e)
    summed = dict(zip(sliced, group.all_reduce_sum(
        torch.stack(list(sliced.values())))))
    grad_sq = (table_sqnorm_estimate(agg) if comp.needs_sketch_spec
               else summed["grad"])
    diag = {"diag/grad_norm": torch.sqrt(grad_sq),
            "diag/update_norm": torch.sqrt(summed["update"])}
    ef = (torch.sqrt(summed["ef"]) if e_kind == KIND_DENSE
          else torch.sqrt(table_sqnorm_estimate(new_e))
          if e_kind == KIND_TABLE else None)
    if ef is not None:
        diag["diag/ef_residual_norm"] = ef
        diag["diag/ef_residual_max"] = ef
    s = nonfinite_sentinel([loss] + list(diag.values()))
    diag["diag/nonfinite"] = torch.maximum(s, (summed["bad"] > 0).to(
        torch.float32))
    return diag


def build_fsdp_round_fn(cfg, loss_fn: Callable, unravel: Callable, comp,
                        group):
    """``round_fn(state, client_ids, batch, lr, mark=None, env=None) ->
    (new_state, metrics)``, the same contract as ``build_round_fn``'s,
    with ``state.params_vec`` and the dense server leaves this rank's
    ``[S]`` slices. ``mark(i)`` as there (0: gather and gradients, 1: the
    loss sums, 2: the server step with its exchanges, 3: the diagnostics
    at ``telemetry_level >= 1``, 4: the end)."""
    validate_fsdp(cfg, comp)
    comp.resolved_dampening()
    W, d = cfg.num_workers, comp.d
    dp = padded_dim(d, group.size)
    S = dp // group.size
    w_loc = W // group.size
    lo = group.rank * w_loc
    fedsim = bool(cfg.fedsim_enabled)
    # the reference's FSDP gate for the flattened-batch gradient (every
    # FSDP mode supports it; client state is refused above)
    fused = (cfg.fuse_clients and cfg.max_grad_norm is None
             and cfg.dp_noise_multiplier == 0 and not fedsim)
    per_client = make_per_client(cfg, comp,
                                 make_grad_one(cfg, loss_fn, unravel))
    grad_flat = make_grad_one(cfg, loss_fn, unravel, batched=False)
    telemetry = cfg.telemetry_level >= 1

    @torch.no_grad()
    def round_fn(state: FedState, client_ids, batch, lr: float,
                 mark: Optional[Callable] = None, env=None):
        mark = mark or (lambda i: None)
        if fedsim and env is None:
            raise ValueError(
                "fedsim is enabled (cfg.fedsim_enabled) but no env was "
                "passed: supply the round's fedsim.RoundEnv "
                "(FederatedSession.train_round does this)")
        mark(0)
        full = group.all_gather(state.params_vec)[:d]
        if fused:
            local, loss_sum, aux = fused_grad_sum(grad_flat, full, batch)
        else:
            gathered = FedState(full, step=state.step)
            local, loss_sum, aux, _, _ = batched_client_transmits(
                per_client, *client_inputs(cfg, comp, gathered, client_ids,
                                           batch, lr,
                                           env if fedsim else None, lo))
        del full
        mark(1)
        keys = list(aux)
        sums = group.all_reduce_sum(torch.stack([loss_sum]
                                                + [aux[k] for k in keys]))
        loss, aux = sums[0] / W, dict(zip(keys, sums[1:]))
        count = float(env.live_count) if fedsim else None
        if fedsim:
            # the live-count renormalization before the sums over W inside
            # fsdp_update: every encode is linear, so it commutes
            scale = live_scale(W, count)
            local, loss = local * scale, loss * scale
        mark(2)
        new_p, new_m, new_e, agg = comp.fsdp_update(
            state.params_vec, state.momentum, state.error, local, lr,
            group=group, W=W, d=d, dp=dp, S=S)
        if fedsim and count <= 0:  # nothing arrived: nothing moves
            new_p, new_m, new_e = state.params_vec, state.momentum, \
                state.error
        mark(3)
        metrics = {"loss": loss, **aux}
        if telemetry:
            metrics.update(fsdp_diagnostics(
                comp, group, agg=agg, p_sh=state.params_vec, new_p=new_p,
                new_e=new_e, loss=loss))
        new_state = FedState(new_p, new_m, new_e, None, None,
                             state.step + 1, None)
        mark(4)
        return new_state, metrics

    return round_fn

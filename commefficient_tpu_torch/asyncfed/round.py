"""The asyncfed round programs, one launch and one apply a rung (the port's
copy of ``commefficient_tpu/asyncfed/round.py``).

The synchronous round (``parallel/round.py``) runs the clients, sums their
transmits, encodes, aggregates and updates the server. Buffered asynchrony
splits it at the one seam the algebra allows, after each client's transmit
and before anything is summed:

* ``launch_fn`` runs one cohort's per-client half against the params it
  launches on: the ``[W, D]`` transmit rows (before the encode and the
  sum), the new momentum/error rows and the per-client loss and aux. It
  is ``make_per_client``'s function batched by ``batched_client_rows``,
  the one the synchronous round sums, so a launched row is the row the
  synchronous round would have made from the same params.

* ``apply_fn`` takes the update's ``[W, ...]`` assembly (K consumed rows,
  padded with zero-weight repeats), weights each row by its staleness
  discount times its live mask behind a ``torch.where`` gate, sums them,
  encodes the sum once (``device_encode``: K1 under sketch; every encode
  is linear, so the encode of the weighted sum is the weighted sum of the
  encodes), and runs the synchronous round's aggregation tail, server
  phase (``count = sum(weights)``: the participation the update
  renormalizes by, the fedsim live count at alpha 0) and apply, then
  writes the client rows back slot by slot.

The anchor (K = W, C = 1, alpha = 0) is bit-equal to the synchronous
round: every weight is the 0/1 live mask, ``row * 1.0`` is the row, the
where-gate gives the synchronous dead-slot zeros, the canonical (cohort,
slot) order makes the slots ``0..W-1`` and the sum the same ``torch.sum(t,
0)``, the DP draws are keyed by the launch version (= the round's step),
and ``count == live_count`` exactly (small integers in f32), which scales
by exactly 1.0 without fedsim.

In a worker group each rank launches its ``w_loc`` clients and the rows
are all-gathered, so every rank holds the cohort's ``[W, ...]`` rows; the
apply sums this rank's slice ``[lo, lo + w_loc)`` of the assembly and
aggregates over the group as the synchronous round does.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

import numpy as np
import torch

from commefficient_tpu_torch.parallel.round import (
    FedState,
    apply_update,
    batched_client_rows,
    client_inputs,
    live_scale,
    make_aggregate_tail,
    make_grad_one,
    make_per_client,
    resolve_aggregation,
    round_diag,
    server_phase,
)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device``; on the card through pinned memory
    without waiting (a pageable copy would wait for the stream's queued
    work: the host would no longer run ahead of the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def write_back(bank, client_ids: np.ndarray, weights: np.ndarray, rows):
    """Write ``rows`` ([W, D], slot order) into ``bank`` at ``client_ids``
    for the slots whose weight is live, slot by slot in order: a client
    two consumed slots share keeps the later one. One ``index_copy_`` of
    each client's last live slot (its indices distinct, so the scatter's
    order on the card cannot matter)."""
    if bank is None:
        return
    last = {}
    for i, (cid, w) in enumerate(zip(client_ids.tolist(), weights.tolist())):
        if w > 0:
            last[int(cid)] = i
    if not last:
        return
    slots = to_device(np.asarray(list(last.values()), np.int64), bank.device)
    ids = to_device(np.asarray(list(last.keys()), np.int64), bank.device)
    bank.index_copy_(0, ids, rows.index_select(0, slots))


def build_async_round_fns(cfg, loss_fn: Callable, unravel: Callable, comp,
                          group):
    """``(launch_fn, apply_fn)`` of one rung:

    ``launch_fn(state, client_ids, batch, version, lr, env=None) -> (rows
    [W, D], vel_rows [W, D] | None, err_rows [W, D] | None, loss_rows [W],
    aux_rows {k: [W]})``: ``client_ids`` the cohort's ``[W]`` ids on the
    state's device, ``batch`` this rank's clients ({k: [w_loc, ...]}),
    ``version`` the server version the cohort launches against (the DP
    draws' key), ``lr`` the cohort's, ``env`` its ``fedsim.RoundEnv``
    (required under fedsim). Reads the state, changes nothing.

    ``apply_fn(state, rows, vel_rows, err_rows, loss_rows, aux_rows,
    client_ids, weights, wsum, lr, draw=None) -> (new_state, metrics)``:
    the ``[W, ...]`` assembly, ``client_ids`` and ``weights`` ([W] host
    arrays: the staleness discount times the live mask, 0 on padding),
    ``wsum`` their f32 sum, ``draw`` the server step's
    (``session.server_draw(state.step)``). The client banks are written in place
    (``write_back``), as the synchronous round writes them."""
    comp.resolved_dampening()  # the mode's warnings, once, at build time
    per_client = make_per_client(cfg, comp,
                                 make_grad_one(cfg, loss_fn, unravel))
    plan = resolve_aggregation(cfg, comp, group.size)
    fedsim = bool(cfg.fedsim_enabled)
    W = cfg.num_workers
    w_loc = W // group.size
    lo = group.rank * w_loc
    aggregate_tail = make_aggregate_tail(cfg, comp, plan, group, comp.d)
    telemetry = cfg.telemetry_level >= 1

    @torch.no_grad()
    def launch_fn(state: FedState, client_ids, batch, version: int, lr: float,
                  env=None):
        if fedsim and env is None:
            raise ValueError(
                "fedsim is enabled (cfg.fedsim_enabled) but no env was "
                "passed: supply the cohort's fedsim.RoundEnv "
                "(asyncfed.AsyncFederation does this)")
        rows, vel, err, loss, aux = batched_client_rows(
            per_client, *client_inputs(cfg, comp, state, client_ids, batch,
                                       lr, env if fedsim else None, lo,
                                       key_step=version))

        def gather(t):  # every rank holds the cohort's [W, ...] rows
            return None if t is None else group.all_gather(t)

        return (gather(rows), gather(vel), gather(err), gather(loss),
                {k: gather(v) for k, v in aux.items()})

    @torch.no_grad()
    def apply_fn(state: FedState, rows, vel_rows, err_rows, loss_rows,
                 aux_rows, client_ids, weights, wsum: float, lr: float,
                 draw=None):
        # the weights and their sum in one copy; the sum stays on the card
        wts = to_device(np.append(np.asarray(weights, np.float32),
                                  np.float32(wsum)), state.params_vec.device)
        wt, wsum = wts[lo:lo + w_loc], wts[-1]
        on = wt > 0
        # where, not a product alone: a zero-weight slot (a dead client,
        # or the padding's repeat of a consumed slot) adds exactly 0.0
        # even when its row is NaN; a live slot's row * 1.0 is the row
        contrib = torch.where(on[:, None], rows[lo:lo + w_loc] * wt[:, None],
                              0.0)
        local = torch.sum(contrib, 0)
        loss_sum = torch.sum(torch.where(
            on, loss_rows[lo:lo + w_loc] * wt, 0.0), 0)
        aux = {k: torch.sum(torch.where(on, v[lo:lo + w_loc] * wt, 0.0), 0)
               for k, v in aux_rows.items()}
        agg, loss, aux = aggregate_tail(comp.device_encode(local), loss_sum,
                                        aux, w_loc)
        loss = loss * live_scale(W, wsum)  # the mean over the live weight
        update, new_m, new_e, new_c, agg = server_phase(
            cfg, comp, plan, group, state, agg, lr, count=wsum, draw=draw)
        new_state = replace(
            state, params_vec=apply_update(state.params_vec, update),
            momentum=new_m, error=new_e, comp=new_c, step=state.step + 1)
        ids = np.asarray(client_ids, np.int64)
        w = np.asarray(weights, np.float32)
        write_back(state.client_vel, ids, w, vel_rows)
        write_back(state.client_err, ids, w, err_rows)
        metrics = {"loss": loss, **aux}
        if telemetry:
            metrics.update(round_diag(cfg, comp, plan, group, state,
                                      new_state, update, agg, loss, lr,
                                      err_rows))
        return new_state, metrics

    return launch_fn, apply_fn

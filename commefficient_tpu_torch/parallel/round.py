"""The federated round (the reference's ``parallel/round.py``, the subset
the port runs).

A round over a worker group of ``Wd`` devices (``parallel/mesh.py``), one
process per device: rank ``p`` computes the gradients of its clients
``[p*w_loc, (p+1)*w_loc)`` of the W participants (``w_loc = W / Wd``, the
reference's ``P(WORKERS)`` split; weight decay and the global-norm clip
per client) -> their sum -> the compressor's LINEAR ``device_encode`` ->
the sum over the group, divided by W (the reference's psum / W; an
identity sum on one device) -> the server phase, replicated on every rank:
either the dense decode (``server_update`` -> ``w -= delta``) or the
sharded decode (``server_update_sharded`` -> ``w[idx] -= val``, the dense
delta never formed).

The reference ``vmap``s the clients and sums the stack; here clients run
one after another and their gradients are summed in client order.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, NamedTuple, Optional

import torch

from commefficient_tpu_torch.models.losses import IGNORE_INDEX
from commefficient_tpu_torch.ops.param_utils import clip_by_global_norm


@dataclass
class FedState:
    """Server state, replicated on every rank. Absent leaves are ``None``."""

    params_vec: torch.Tensor  # [D]
    momentum: Optional[torch.Tensor] = None  # [D] | [r, c] | None
    error: Optional[torch.Tensor] = None  # [D] | [r, c] | None
    step: int = 0


class AggregationPlan(NamedTuple):
    """How the server phase decodes: the reference's plan reduced to the
    one choice the port runs (the sparse aggregation fields wait for
    ROADMAP A9)."""

    sharded_decode: bool


def resolve_aggregation(cfg, comp, Wd: int) -> AggregationPlan:
    return AggregationPlan(sharded_decode=comp.use_sharded_decode(Wd))


def init_state(comp, params_vec: torch.Tensor) -> FedState:
    """Allocate exactly the state the (mode, error_type, momentum)
    combination needs (shapes from the compressor)."""
    momentum, error = comp.init_server_state(params_vec.device)
    return FedState(params_vec.to(torch.float32), momentum, error, 0)


def make_grad_one(cfg, loss_fn: Callable, unravel: Callable):
    """``(params_vec, batch) -> (flat grad [D], loss, aux)`` with weight
    decay and the global-norm clip, in the reference's order. The loss
    reads its parameters as views of the flat vector, so the gradient comes
    out in the reference's coordinate order."""

    def grad_one(params_vec, batch):
        p = params_vec.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, aux = loss_fn(unravel(p), batch)
            (g,) = torch.autograd.grad(loss, p)
        g = g.to(torch.float32)
        if cfg.weight_decay:
            g = g + cfg.weight_decay * params_vec
        g = clip_by_global_norm(g, cfg.max_grad_norm)
        return g, loss.detach(), {k: v.detach() for k, v in aux.items()}

    return grad_one


def sum_client_grads(grad_one, params_vec, batch: Dict[str, torch.Tensor]):
    """(sum of per-client grads [D], loss sum, aux sums) over the clients
    of ``batch`` ({k: [w, B, ...]}), in client order."""
    W = next(iter(batch.values())).shape[0]
    g_sum = loss_sum = aux_sum = None
    for w in range(W):
        g, loss, aux = grad_one(params_vec, {k: v[w] for k, v in batch.items()})
        if g_sum is None:
            g_sum, loss_sum, aux_sum = g, loss, dict(aux)
        else:
            g_sum = g_sum + g
            loss_sum = loss_sum + loss
            aux_sum = {k: aux_sum[k] + v for k, v in aux.items()}
    return g_sum, loss_sum, aux_sum


def aggregate(cfg, comp, group, local, loss_sum, aux):
    """``(agg, loss_mean, aux_sum)``: the encoded transmit summed over the
    group and divided by W, the mean client loss, the summed aux."""
    W = cfg.num_workers
    agg = group.all_reduce_sum(comp.device_encode(local)) / W
    keys = list(aux)
    sums = group.all_reduce_sum(torch.stack([loss_sum]
                                            + [aux[k] for k in keys]))
    return agg, sums[0] / W, dict(zip(keys, sums[1:]))


def server_phase(cfg, comp, plan: AggregationPlan, group, state: FedState,
                 agg, lr: float):
    """The server half of a round: the compressor's momentum/error algebra
    and extraction (dense or sharded decode), then, for the dense decode,
    the optional downlink top-k. Returns ``(update, new_momentum,
    new_error)`` for ``apply_update``: ``("dense", delta)`` or
    ``("sparse", (idx, val))``."""
    if plan.sharded_decode:
        g_idx, g_val, new_m, new_e = comp.server_update_sharded(
            state.momentum, state.error, agg, lr, group=group,
            d=state.params_vec.numel())
        return ("sparse", (g_idx, g_val)), new_m, new_e
    delta, new_m, new_e = comp.server_update(state.momentum, state.error,
                                             agg, lr)
    if cfg.do_topk_down and comp.dense_delta:
        delta = comp.topk(delta, cfg.k)
    return ("dense", delta), new_m, new_e


def apply_update(params_vec: torch.Tensor, update) -> torch.Tensor:
    """``w - delta``, or for the sharded decode's gathered candidates
    ``w`` with ``val`` subtracted at ``idx`` (a new tensor: the state it
    came from stays as it was). Candidate coordinates are distinct apart
    from pads, whose val is 0.0, so the scatter's order cannot change the
    sum."""
    kind, u = update
    if kind == "dense":
        return params_vec - u
    g_idx, g_val = u
    return params_vec.index_add(0, g_idx, -g_val)


def build_round_fn(cfg, loss_fn: Callable, unravel: Callable, comp, group):
    """``round_fn(state, batch, lr) -> (new_state, metrics)``; ``batch``
    holds this rank's clients."""
    grad_one = make_grad_one(cfg, loss_fn, unravel)
    plan = resolve_aggregation(cfg, comp, group.size)

    @torch.no_grad()
    def round_fn(state: FedState, batch, lr: float):
        local, loss_sum, aux = sum_client_grads(grad_one, state.params_vec,
                                                batch)
        agg, loss, aux = aggregate(cfg, comp, group, local, loss_sum, aux)
        update, new_m, new_e = server_phase(cfg, comp, plan, group, state,
                                            agg, lr)
        new_state = replace(state,
                            params_vec=apply_update(state.params_vec, update),
                            momentum=new_m, error=new_e, step=state.step + 1)
        return new_state, {"loss": loss, **aux}

    return round_fn


def mask_classification(batch, row_mask):
    y = torch.where(row_mask, batch["y"],
                    torch.full_like(batch["y"], IGNORE_INDEX))
    return {**batch, "y": y}


def build_eval_fn(loss_fn: Callable, unravel: Callable):
    """``eval_step(params_vec, batch-with-_valid) -> metric sums``: padded
    tail rows are masked to IGNORE_INDEX."""

    @torch.no_grad()
    def eval_step(params_vec, batch):
        batch = dict(batch)
        valid = int(batch.pop("_valid"))
        n = next(iter(batch.values())).shape[0]
        row_mask = torch.arange(n, device=params_vec.device) < valid
        loss, aux = loss_fn(unravel(params_vec), mask_classification(batch, row_mask))
        return {"loss_sum": loss * valid, **aux}

    return eval_step

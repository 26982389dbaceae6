"""The federated round on one device (the reference's ``parallel/round.py``,
single-device dense-decode subset).

A round: per-client gradients over the W participating clients (weight
decay and the global-norm clip per client) -> their sum -> the
compressor's LINEAR ``device_encode`` -> the average over W (the
reference's psum / W, an identity psum on one device) -> the compressor's
server update -> ``w -= delta``.

The reference ``vmap``s the clients and sums the stack; here clients run
one after another and their gradients are summed in client order.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import torch

from commefficient_tpu_torch.models.losses import IGNORE_INDEX
from commefficient_tpu_torch.ops.param_utils import clip_by_global_norm


@dataclass
class FedState:
    """Server state. Absent leaves are ``None``."""

    params_vec: torch.Tensor  # [D]
    momentum: Optional[torch.Tensor] = None  # [D] | [r, c] | None
    error: Optional[torch.Tensor] = None  # [D] | [r, c] | None
    step: int = 0


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
    of ``batch`` ({k: [W, B, ...]}), in client order."""
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


def build_round_fn(cfg, loss_fn: Callable, unravel: Callable, comp):
    """``round_fn(state, batch, lr) -> (new_state, metrics)``."""
    grad_one = make_grad_one(cfg, loss_fn, unravel)
    W = cfg.num_workers

    @torch.no_grad()
    def round_fn(state: FedState, batch, lr: float):
        local, loss_sum, aux = sum_client_grads(grad_one, state.params_vec,
                                                batch)
        agg = comp.device_encode(local) / W  # linear: exact aggregate
        delta, new_m, new_e = server_phase(cfg, comp, state, agg, lr)
        new_state = replace(state, params_vec=state.params_vec - delta,
                            momentum=new_m, error=new_e, step=state.step + 1)
        return new_state, {"loss": loss_sum / W, **aux}

    return round_fn


def server_phase(cfg, comp, state: FedState, agg, lr: float):
    """The dense-decode server half of a round: the compressor's momentum/
    error algebra and extraction, then the optional downlink top-k.
    Returns ``(delta, new_momentum, new_error)``."""
    delta, new_m, new_e = comp.server_update(state.momentum, state.error,
                                             agg, lr)
    if cfg.do_topk_down and comp.dense_delta:
        delta = comp.topk(delta, cfg.k)
    return delta, new_m, new_e


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

"""The federated round, plain PyTorch in float32, followed from the
initial weights through a cell's first rounds.

Each of the W clients takes the gradient of its mean loss on its own
batch, adds weight decay and, where the configuration clips, scales it
to at most ``max_grad_norm``; the server averages the clients'
gradients and updates:

* ``uncompressed``: ``m = rho m + g``, ``w -= lr m``;
* ``sketch`` (FetchSGD, virtual momentum and error): on tables,
  ``S_m = rho S_m + S(g)``, ``S_e += lr S_m``, ``delta = TopK(U(S_e))``,
  ``S_e -= S(delta)``, ``w -= delta``.

``rnd`` rounds every product (``precision.py``);
``fault="half_batch"`` drops the second half of every client's batch (the
mean then runs over the rest)."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional

import torch

from benchmark.reference import countsketch
from benchmark.yardstick.layout import leaves, offsets


def views(vec: torch.Tensor, cfg: dict) -> Dict[str, torch.Tensor]:
    """Each leaf's path -> its view of the flat vector."""
    layout = leaves(cfg)
    return {path: vec[o:o + n].view(shape)
            for (path, shape), (_, o, n) in zip(layout, offsets(layout))}


def client_grad(model_loss: Callable, cfg: dict, w: torch.Tensor,
                batch: Dict[str, torch.Tensor], rnd):
    """(flat gradient of the client's mean loss, the loss)."""
    w = w.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = model_loss(cfg, views(w, cfg), batch, rnd)
        (g,) = torch.autograd.grad(loss, [w])
    return g, loss.detach()


def run(cfg: dict, opt: dict, seed: int, w0: torch.Tensor,
        batches: List[Dict[str, torch.Tensor]], lr: float, rnd,
        state_after: int, fault: str = "",
        after_round: Optional[Callable[[int, torch.Tensor], None]] = None
        ) -> dict:
    """Follow ``len(batches)`` rounds from ``w0`` under the optimizer
    settings ``opt``; ``seed`` keys the sketch's hashes. Returns ``{"losses":
    [per round], "state": the momentum (a table in sketch mode) after
    ``state_after`` rounds, "params": w after the last round}``;
    ``after_round(r, w)`` sees the parameters after each round."""
    model_loss = importlib.import_module(
        f"benchmark.reference.{cfg['family']}").loss
    sketched = opt["mode"] == "sketch"
    if sketched:
        geo = countsketch.Geometry(w0.numel(), opt["num_cols"],
                                   opt["num_rows"], seed)
    w = w0.clone()
    m = e = None
    out = {"losses": []}
    for r, batch in enumerate(batches):
        total, losses = torch.zeros_like(w), []
        W = next(iter(batch.values())).shape[0]
        for i in range(W):
            b = {k: v[i] for k, v in batch.items()}
            if fault == "half_batch":
                b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
            g, loss = client_grad(model_loss, cfg, w, b, rnd)
            g = g + opt["weight_decay"] * w
            if opt.get("max_grad_norm") is not None:
                norm = torch.linalg.vector_norm(g)
                g = g * torch.clamp(opt["max_grad_norm"] / (norm + 1e-12),
                                    max=1.0)
            total += g
            losses.append(loss)
        out["losses"].append(float(torch.stack(losses).mean()))
        rho = opt["virtual_momentum"]
        if sketched:
            agg = countsketch.sketch(geo, total) / W
            m = agg if m is None else rho * m + agg
            e = lr * m if e is None else e + lr * m
            est = countsketch.estimate(geo, e)
            idx = torch.topk(est.abs(), opt["k"]).indices
            delta = torch.zeros_like(est)
            delta[idx] = est[idx]
            e = e - countsketch.sketch(geo, delta)
            w = w - delta
        else:
            agg = total / W
            m = agg if m is None else rho * m + agg
            w = w - lr * m
        if r + 1 == state_after:
            out["state"] = m.clone()
        if after_round is not None:
            after_round(r, w)
        del total
    out["params"] = w
    return out

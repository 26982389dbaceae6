"""FederatedSession, FedModel, FedOptimizer — the reference's public API
(``parallel/api.py``), single-device subset.

``FederatedSession`` owns the state and the round; ``FedModel`` is the
callable facade (``fed_model(client_ids, batch)`` runs one round at the
optimizer's lr) and ``FedOptimizer`` the schedule clock (``step()``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from commefficient_tpu_torch import resolve_device
from commefficient_tpu_torch.compress import compressor_class, get_compressor
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.parallel.round import (
    build_eval_fn,
    build_round_fn,
    init_state,
)


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


class FederatedSession:
    """Owns the device, the CountSketch spec, the compressor, the round and
    the ``FedState``. ``params`` is a nested dict of arrays/tensors keyed
    like the reference's flax params (``ravel_pytree`` order)."""

    def __init__(self, cfg, params: Any, loss_fn: Callable):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        vec, unravel = ravel_params(params)
        self.unravel = unravel
        self.grad_size = int(vec.numel())
        self.spec = None
        if compressor_class(cfg.mode).needs_sketch_spec:
            self.spec = CountSketch(
                d=self.grad_size, c=cfg.num_cols, r=cfg.num_rows,
                num_blocks=cfg.num_blocks, seed=cfg.seed, m=cfg.sketch_m,
                band=cfg.sketch_band, hash_family=cfg.hash_family)
        self.compressor = get_compressor(cfg, d=self.grad_size,
                                         spec=self.spec)
        self.state = init_state(self.compressor, vec.to(self.device))
        self.round_fn = build_round_fn(cfg, loss_fn, unravel,
                                       self.compressor)
        self.eval_fn = build_eval_fn(loss_fn, unravel)

    def train_round(self, client_ids, batch: Dict[str, Any], lr: float):
        """One round on ``batch`` ({k: [W, B, ...]} host arrays). Returns the
        round's metrics as 0-d device tensors (``loss`` = mean client
        loss). ``client_ids`` name the participants; no per-client state
        is kept in this slice."""
        del client_ids
        lr = float(np.float32(lr))  # the reference's f32 lr
        self.state, metrics = self.round_fn(
            self.state, _to_device(batch, self.device), lr)
        return metrics

    def evaluate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """Mean loss and accuracy over eval batches (padded rows masked)."""
        totals: Dict[str, float] = {}
        n = 0.0
        pv = self.state.params_vec
        for b in batches:
            out = self.eval_fn(pv, _to_device(b, self.device))
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += float(np.asarray(b["_valid"]))
        if n == 0:
            return {"loss": float("nan")}
        result = {"loss": totals.get("loss_sum", 0.0) / n}
        if totals.get("count", 0.0) > 0:
            result["accuracy"] = totals.get("correct", 0.0) / totals["count"]
        return result

    @property
    def params(self):
        return self.unravel(self.state.params_vec)

    def bytes_per_round(self) -> Dict[str, int]:
        """Upload/download bytes per participating client."""
        comp = self.compressor
        up = comp.upload_floats()
        down = 2 * self.cfg.k if self.cfg.do_topk_down else \
            comp.download_floats()
        return {"upload_floats": up, "download_floats": down,
                "upload_bytes": comp.upload_bytes_per_float() * up,
                "download_bytes": 4 * down}


class FedModel:
    """Callable facade over a session."""

    def __init__(self, session: FederatedSession):
        self.session = session
        self.optimizer: Optional["FedOptimizer"] = None

    def __call__(self, client_ids, batch, lr: Optional[float] = None):
        if lr is None:
            if self.optimizer is None:
                raise ValueError("no lr given and no FedOptimizer attached; "
                                 "pass lr= or construct via make_fed_pair")
            lr = self.optimizer.get_lr()
        return self.session.train_round(client_ids, batch, lr)

    def evaluate(self, batches):
        return self.session.evaluate(batches)

    @property
    def params(self):
        return self.session.params


class FedOptimizer:
    """Schedule clock; the server update itself runs inside the round."""

    def __init__(self, session: FederatedSession,
                 lr_fn: Callable[[int], float]):
        self.session = session
        self.lr_fn = lr_fn
        self._step = 0

    def get_lr(self) -> float:
        return float(self.lr_fn(self._step))

    def step(self) -> None:
        self._step += 1

    def zero_grad(self) -> None:
        pass


def make_fed_pair(cfg, params, loss_fn, lr_fn):
    """Reference-style constructor: (FedModel, FedOptimizer) sharing a
    session."""
    session = FederatedSession(cfg, params, loss_fn)
    model, opt = FedModel(session), FedOptimizer(session, lr_fn)
    model.optimizer = opt
    return model, opt

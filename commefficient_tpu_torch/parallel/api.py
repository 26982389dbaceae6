"""FederatedSession, FedModel, FedOptimizer — the reference's public API
(``parallel/api.py``), the subset the port runs.

``FederatedSession`` owns the worker group, the state and the round;
``FedModel`` is the callable facade (``fed_model(client_ids, batch)`` runs
one round at the optimizer's lr) and ``FedOptimizer`` the schedule clock
(``step()``).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from commefficient_tpu_torch import resolve_device
from commefficient_tpu_torch.compress import compressor_class, get_compressor
from commefficient_tpu_torch.fedsim import build_environment
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.parallel.envelope import (
    predicted_dc_max,
    stable_dc_bound,
)
from commefficient_tpu_torch.parallel.mesh import local_rank, make_worker_group
from commefficient_tpu_torch.parallel.round import (
    build_eval_fn,
    build_round_fn,
    init_state,
    mask_classification,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def envelope_warning(d: int, c_actual: int,
                     error_decay: float) -> Optional[str]:
    """The reference session's d/c warning, or None: a realized ``d /
    c_actual`` above ``stable_dc_bound(error_decay)`` is outside the
    fitted stable envelope of the error feedback (``parallel/
    envelope.py``). The suggested ``num_cols`` pads the realized target by
    5%, enough that following it clears the check (the realized width
    deviates a few percent from the request)."""
    bound = stable_dc_bound(error_decay)
    if d <= bound * c_actual:
        return None
    suggest = -(-(int(d / bound) + 1) * 21 // 20)
    decay_note = "" if error_decay < 0.95 else (
        " or lower error_decay (gamma=0.9 moves the fitted cliff to d/c "
        f"~{predicted_dc_max(0.9):.0f})")
    return (
        f"sketch mode at realized d/c = {d / c_actual:.1f} (c_actual="
        f"{c_actual:,}) is OUTSIDE the stable envelope for error_decay="
        f"{error_decay:g}: the fitted error-bank model (parallel/"
        f"envelope.py) puts the cliff at d/c ~"
        f"{predicted_dc_max(error_decay):.0f} for this gamma (warning "
        f"threshold {bound:.0f}, the last measured-stable point). Raise "
        f"num_cols to >= {suggest:,}{decay_note}.")


def _sum_key(k: str) -> bool:
    """Eval metrics that are already masked sums over a batch (summed
    across batches as they are); any other key is a per-batch mean."""
    return k in ("loss_sum", "correct", "count") or k.endswith(
        ("_sum", "_count"))


def microbatched(cfg, batch: Dict[str, Any]) -> Dict[str, Any]:
    """A sampler's ``[W, L*B, ...]`` round batch in the ``[W, L, B, ...]``
    layout of fedavg's ``L = cfg.round_microbatches`` local steps (the
    reference's convention); other modes' batches as they are."""
    L = cfg.round_microbatches
    if not L:
        return batch
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    return {k: a.reshape((a.shape[0], L, a.shape[1] // L) + a.shape[2:])
            for k, a in arrays.items()}


class FederatedSession:
    """Owns the worker group, the device, the CountSketch spec, the
    compressor, the round and the ``FedState``. ``params`` is a nested dict
    of arrays/tensors keyed like the reference's flax params
    (``ravel_pytree`` order). With ``num_devices > 1`` the session is one
    rank of the group (``parallel/mesh.py``) on ``cuda:LOCAL_RANK``; every
    rank holds the same state. ``mask_batch(batch, row_mask)`` masks an
    eval batch's padded rows (``mask_classification``, or ``mask_gpt2``
    for the GPT-2 batch)."""

    def __init__(self, cfg, params: Any, loss_fn: Callable,
                 mask_batch: Callable = mask_classification):
        self.cfg = cfg
        self.group = make_worker_group(cfg)
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda" and self.group.size > 1:
            self.device = torch.device("cuda", local_rank())
            torch.cuda.set_device(self.device)
        vec, unravel = ravel_params(params)
        self.unravel = unravel
        self.grad_size = int(vec.numel())
        self.spec = None
        if compressor_class(cfg.mode).needs_sketch_spec:
            self.spec = CountSketch(
                d=self.grad_size, c=cfg.num_cols, r=cfg.num_rows,
                num_blocks=cfg.num_blocks, seed=cfg.seed, m=cfg.sketch_m,
                band=cfg.sketch_band, hash_family=cfg.hash_family,
                dtype=_DTYPES[cfg.sketch_dtype],
                table_dtype=_DTYPES[cfg.sketch_table_dtype])
            msg = envelope_warning(self.grad_size, self.spec.c_actual,
                                   cfg.error_decay)
            if msg:
                warnings.warn(msg, stacklevel=2)
        self.compressor = get_compressor(cfg, d=self.grad_size,
                                         spec=self.spec)
        # which server decode the round runs (cfg.sketch_decode resolved
        # for this group; build_round_fn makes the same call)
        self.sketch_decode_resolved = (
            "sharded" if self.compressor.use_sharded_decode(self.group.size)
            else "dense")
        if cfg.sketch_decode == "sharded" and self.group.size == 1:
            warnings.warn(
                "sketch_decode='sharded' on a 1-device worker group is the "
                "degenerate case: the one 'shard' decodes the FULL "
                "coordinate range through estimate_at, and the candidate "
                "exchange has no one to exchange with. The sharded decode "
                "only pays when the worker group is real; 'auto' picks "
                "dense here for exactly that reason.", stacklevel=2)
        self.state = init_state(cfg, self.compressor, vec.to(self.device))
        # the fedsim environment (None unless cfg.fedsim_enabled): round
        # state.step's masks, a pure function of (seed, step), so a
        # restored step realizes what the unbroken run realized
        self.fedsim_env = build_environment(cfg)
        self.round_fn = build_round_fn(cfg, loss_fn, unravel,
                                       self.compressor, self.group)
        self.eval_fn = build_eval_fn(loss_fn, unravel, mask_batch)

    def local_clients(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's slice ``[p*w_loc, (p+1)*w_loc)`` of a round's
        ``[W, ...]`` host batch."""
        w_loc = self.cfg.num_workers // self.group.size
        lo = self.group.rank * w_loc
        return {k: np.asarray(v)[lo:lo + w_loc] for k, v in batch.items()}

    def train_round(self, client_ids, batch: Dict[str, Any], lr: float,
                    env=None):
        """One round on ``batch`` ({k: [W, B, ...]} host arrays, for fedavg
        ``[W, L, B, ...]`` (``microbatched``); the same on every rank, and
        each rank computes its own clients). ``client_ids`` ([W] ints) name
        the participants; modes with client state (local momentum, local
        error feedback) need them and raise without, the others may pass
        ``None``. Returns the round's metrics as 0-d device tensors
        (``loss`` = mean client loss over all W, over the live clients
        under fedsim), plus the ``fedsim/*`` host scalars under fedsim.

        ``env`` (a ``fedsim.RoundEnv``) overrides the session
        environment's draw for this round (tests drive explicit masks
        through it); by default a fedsim session realizes round
        ``state.step``'s environment. An ``env`` for a session built
        without fedsim raises."""
        if env is None and self.fedsim_env is not None:
            env = self.fedsim_env.round_env(self.state.step)
        elif env is not None and self.fedsim_env is None:
            raise ValueError(
                "env= passed but this session was built without fedsim "
                "(cfg.fedsim_enabled is False, so the round masks "
                "nothing); construct the Config with availability/chaos "
                "set to drive masked rounds")
        ids = None
        if client_ids is not None:
            host = np.asarray(client_ids, dtype=np.int64)
            if (host.shape != (self.cfg.num_workers,) or host.min() < 0
                    or host.max() >= self.cfg.num_clients):
                raise ValueError(
                    f"client_ids must be {self.cfg.num_workers} ids in "
                    f"[0, {self.cfg.num_clients}), got {host.tolist()}")
            ids = torch.from_numpy(host).to(self.device)
        lr = float(np.float32(lr))  # the reference's f32 lr
        self.state, metrics = self.round_fn(
            self.state, ids,
            _to_device(self.local_clients(batch), self.device), lr, env=env)
        return {**metrics, **env.stats} if env is not None else metrics

    def evaluate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """Metrics over eval batches (padded rows masked): ``loss`` (the
        mean over valid rows), ``accuracy`` (``correct / count``), the raw
        totals of every other sum-style key (``*_sum``, ``*_count``: the
        GPT-2 token-weighted ``lm_loss_sum`` / ``token_count``), and the
        row-weighted mean of any other key (the reference's rule)."""
        totals: Dict[str, float] = {}
        n = 0.0
        pv = self.state.params_vec
        for b in batches:
            valid = float(np.asarray(b["_valid"]))
            out = self.eval_fn(pv, _to_device(b, self.device))
            for k, v in out.items():
                w = 1.0 if _sum_key(k) else valid
                totals[k] = totals.get(k, 0.0) + w * float(v)
            n += valid
        if n == 0:
            return {"loss": float("nan")}
        result = {"loss": totals.get("loss_sum", 0.0) / n}
        if totals.get("count", 0.0) > 0:
            result["accuracy"] = totals.get("correct", 0.0) / totals["count"]
        for k, v in totals.items():
            if k not in ("loss_sum", "correct", "count"):
                result[k] = v if _sum_key(k) else v / n
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

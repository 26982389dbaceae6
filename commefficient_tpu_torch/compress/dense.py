"""Dense-transmit compressors: ``uncompressed`` and ``fedavg`` (the
reference's ``compress/dense.py``).

``uncompressed`` is the oracle every other mode's degenerate settings
reduce to. ``fedavg`` differs only in the per-client GRADIENT rule:
``num_local_iters`` local SGD steps whose weight delta is transmitted in
gradient scale (divided by the lr used locally); the transmit, aggregate
and server algebra are the dense path unchanged.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.compress.registry import register
from commefficient_tpu_torch.ops.topk import topk_threshold_sharded


class _DenseServerMixin:
    """The dense server update shared by uncompressed, fedavg and
    local_topk. ``_transmit_is_scaled``: the clients transmit values
    already scaled by lr (local_topk's local error banks ``lr * u``), so
    the server must not multiply by lr again."""

    @property
    def _transmit_is_scaled(self) -> bool:
        return False

    def server_update(self, momentum, error, extra, agg, lr: float,
                      step: int):
        rho = self.cfg.virtual_momentum
        applies_lr = not self._transmit_is_scaled
        if rho > 0:
            m = rho * momentum + agg
            return (lr * m if applies_lr else m), m, error, extra
        return (lr * agg if applies_lr else agg), momentum, error, extra


@register("uncompressed")
class DenseCompressor(_DenseServerMixin, Compressor):
    """No compression: dense sum of gradients, plain (momentum) SGD."""

    allowed_error_types = ("none",)
    supports_fused_clients = True
    supports_fsdp = True
    dense_delta = True

    def fsdp_update(self, p_sh, m_in, e_in, local, lr: float, *, group,
                    W: int, d: int, dp: int, S: int):
        # reduce-scatter straight into this rank's slice: the dense server
        # momentum never exists at full size
        agg_sh = group.reduce_scatter(
            torch.nn.functional.pad(local, (0, dp - d))) / W
        rho = self.cfg.virtual_momentum
        if rho > 0:
            m = rho * m_in + agg_sh
            delta_sh = lr * m
        else:
            m = m_in
            delta_sh = lr * agg_sh
        if self.cfg.do_topk_down:
            # the downlink top-k of the broadcast delta, over the group
            delta_sh = topk_threshold_sharded(delta_sh, self.cfg.k, group)
        return p_sh - delta_sh, m, e_in, agg_sh


@register("fedavg")
class FedAvgCompressor(_DenseServerMixin, Compressor):
    """FedAvg: local SGD per client, averaged weight deltas.

    Clients transmit ``(w - w_final) / local_lr`` (gradient scale) and the
    server applies ``lr * mean``. With ``local_lr=None`` the local steps run
    at the round's server lr, so the applied delta is exactly the averaged
    weight delta; an explicit ``local_lr`` scales it by ``lr / local_lr``.
    """

    allowed_error_types = ("none",)
    supports_fused_clients = False  # local SGD is per client by nature
    dense_delta = True

    def client_lr(self, lr: float, device):
        """The local lr as an f32 scalar on ``device`` (so the delta's
        division is a true division, as the reference's is); at ``lr ==
        0`` (the schedule's last round) it is clamped to 1e-12, so the
        delta is 0, not 0/0."""
        cfg = self.cfg
        llr = torch.tensor(cfg.local_lr if cfg.local_lr is not None else lr,
                           dtype=torch.float32, device=device)
        return torch.clamp(llr, min=1e-12) if cfg.local_lr is None else llr

    def client_noise(self, draw, key, batches):
        """A draw a local step, keyed ``(*key, step)``: ``[L, D]``."""
        L = next(iter(batches.values())).shape[0]
        return torch.stack([draw((*key, it)) for it in range(L)])

    def client_grad(self, grad_one, params_vec, batches, noise, lr):
        """``num_local_iters`` SGD steps on the client's microbatches
        (``{k: [L, B, ...]}``), in order, the step's DP draw ``noise[it]``;
        returns the weight delta in gradient scale, the mean loss and the
        mean aux over the steps. ``lr`` is ``client_lr``'s tensor."""
        L = next(iter(batches.values())).shape[0]
        p, losses, auxes = params_vec, [], []
        for it in range(L):
            g, loss, aux = grad_one(
                p, {k: v[it] for k, v in batches.items()},
                noise=None if noise is None else noise[it])
            p = p - lr * g
            losses.append(loss)
            auxes.append(aux)
        delta = (params_vec - p) / lr
        return delta, torch.stack(losses).mean(), {
            k: torch.stack([a[k] for a in auxes]).mean(0) for k in auxes[0]}

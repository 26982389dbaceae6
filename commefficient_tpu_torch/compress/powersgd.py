"""``powersgd`` — rank-r low-rank compression (PowerSGD, arXiv:1905.13727;
the reference's ``compress/powersgd.py``).

The flat ``[D]`` accumulator is matricized to ``[n, m]`` (n ~ m ~ sqrt(D),
zero-padded) and approximated by ONE warm-started power iteration a round:

    P = M @ Q;  P_hat = GS(P);  Q_new = M^T @ P_hat;  M_hat = P_hat @ Q_new^T

Clients transmit dense updates (uplink D floats, summed exactly); the
compression runs at the server on the momentum and error-fed accumulator,
with FetchSGD Algorithm 1's lr-scaled error banking:

    m = rho * m + agg;  e += lr * m;  delta = rank_r(e);  e -= delta

so the downlink is the factored pair, ``r * (n + m)`` floats. At full rank
``P_hat`` spans range(M) and the mode is ``uncompressed`` for any ``Q``.

The two products and Gram-Schmidt are plain ``torch.matmul`` and vector
operations in f32 (TF32 is off on the card, ``resolve_device``); none of
them is a Pallas kernel in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.compress.base import (
    KIND_DENSE,
    Compressor,
    sqnorm,
)
from commefficient_tpu_torch.compress.registry import register

# the reference's stream tag for the Q draws (a copy: the port imports
# nothing of the JAX package); here it seeds a torch.Generator together
# with cfg.seed, and with the step for the non-warm-start draws
POWERSGD_Q_STREAM = 0x9051


def matrix_shape(d: int) -> Tuple[int, int]:
    """Near-square matricization ``[n, m]`` of a flat ``[d]`` vector,
    ``n * m >= d``; square-ish minimizes the factored size ``r * (n + m)``."""
    n = math.isqrt(d)
    if n * n < d:
        n += 1
    m = -(-d // n)
    return n, m


def gram_schmidt(P: torch.Tensor, rel_eps: float = 1e-4) -> torch.Tensor:
    """Orthonormalize the columns of ``P [n, r]`` (a new tensor), the
    reference's CGS2: each column is projected against the already
    orthonormal prefix twice (the second pass restores the f32
    orthogonality one pass loses). A column whose residual falls below
    ``rel_eps`` of its original norm is rank-deficient input and becomes an
    exact zero column instead of normalized noise. Not ``torch.linalg.qr``:
    its signs and its treatment of near-zero columns differ."""
    M = P.clone()
    r = M.shape[1]
    cols = torch.arange(r, device=M.device)
    for j in range(r):
        v = M[:, j]
        nrm0 = torch.linalg.vector_norm(v)
        for _ in range(2):
            coeff = torch.where(cols < j, M.T @ v, 0.0)
            v = v - M @ coeff
        nrm = torch.linalg.vector_norm(v)
        keep = nrm > rel_eps * nrm0
        M[:, j] = torch.where(keep, v / torch.where(keep, nrm, 1.0), 0.0)
    return M


def _gaussian_q(shape, *entropy: int) -> torch.Tensor:
    """A standard normal ``[m, r]`` f32 draw from a CPU ``torch.Generator``
    seeded by ``entropy`` (mixed by numpy's ``SeedSequence``): the same
    numbers whatever device the caller then moves them to."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32)


@register("powersgd")
class PowerSGDCompressor(Compressor):
    allowed_error_types = ("none", "virtual")
    supports_fused_clients = True  # dense transmit, nothing per client
    dense_delta = False  # the delta is rank-r factored

    def __init__(self, cfg, d: int, spec=None):
        super().__init__(cfg, d, spec)
        self.n, self.m = matrix_shape(d)
        self.rank = min(cfg.powersgd_rank, self.n, self.m)

    def server_state_kinds(self):
        # momentum allocated even at rho = 0, as true_topk's
        virtual = self.cfg.error_type == "virtual"
        return (KIND_DENSE, KIND_DENSE if virtual else None)

    def init_extra_state(self, device) -> Optional[torch.Tensor]:
        """The warm-start ``Q [m, r]``, a seed-derived Gaussian; ``None``
        without warm start (each round then draws its own)."""
        if not self.cfg.powersgd_warm_start:
            return None
        return _gaussian_q((self.m, self.rank), self.cfg.seed,
                           POWERSGD_Q_STREAM).to(device)

    def _fresh_q(self, step: int, device) -> torch.Tensor:
        return _gaussian_q((self.m, self.rank), self.cfg.seed,
                           POWERSGD_Q_STREAM, step).to(device)

    def round_draw(self, step: int) -> Optional[torch.Tensor]:
        """Without the warm start, round ``step``'s fresh ``Q [m, r]`` on
        the CPU (the scan engine stages a block's before the replay)."""
        if self.cfg.powersgd_warm_start:
            return None
        return self._fresh_q(step, "cpu")

    def _approx(self, vec, Q):
        """One power iteration: the rank-r approximation of ``vec``'s
        matricization, ``(approx [d], Q_new [m, r])``."""
        M = torch.nn.functional.pad(vec, (0, self.n * self.m - self.d))
        M = M.reshape(self.n, self.m)
        P_hat = gram_schmidt(M @ Q)
        Q_new = M.T @ P_hat
        return (P_hat @ Q_new.T).reshape(-1)[: self.d], Q_new

    def server_update(self, momentum, error, extra, agg, lr: float,
                      step: int, draw: Optional[torch.Tensor] = None):
        """``draw`` is the round's fresh ``Q`` without the warm start,
        made before the round (``round_draw(step)``, on the device)."""
        cfg = self.cfg
        warm = cfg.powersgd_warm_start
        Q = extra if warm else draw
        m = cfg.virtual_momentum * momentum + agg
        if cfg.error_type == "virtual":
            e = error + lr * m
            update, q_new = self._approx(e, Q)
            e = e - update
            if cfg.error_decay != 1.0:
                e = cfg.error_decay * e
            delta = update
        else:
            e = error
            update, q_new = self._approx(m, Q)
            delta = lr * update
        return delta, m, e, (q_new if warm else extra)

    def fidelity(self, *, agg, delta, momentum, error, extra, new_momentum,
                 lr) -> dict:
        """The power iteration's reconstruction residual ``||M - P_hat
        Q_new^T|| / ||M||`` on the real coordinates, M the matricized
        compression input: ``e + lr * m`` with virtual error (applied
        unscaled), else ``lr * m`` against the applied ``lr * approx(m)``
        (the ratio is scale-free). ``m`` is the round's own momentum,
        ``new_momentum``; ``delta`` is the reconstruction. Vector ops
        only."""
        m = new_momentum
        if self.cfg.error_type == "virtual":
            compressed_input = error + lr * m
        else:
            compressed_input = lr * m
        num = torch.sqrt(sqnorm(compressed_input - delta))
        den = torch.sqrt(sqnorm(compressed_input))
        return {"powersgd_recon_rel_err": num / torch.clamp(den, min=1e-30)}

    def migrate_state(self, new, momentum, error, extra):
        """Rank-rung migration: the dense ``[D]`` momentum and error do
        not depend on the rank (they pass through), and the warm-start
        ``Q [m, r]`` migrates by its columns: a lower rank keeps the first
        ``r_new`` columns (the power iteration re-orthonormalizes P each
        round, so the kept columns go on tracking the top subspace), a
        higher rank appends the new compressor's seed-derived Gaussian
        columns ``r_old..r_new`` (the paper's start for directions not yet
        tracked). Without warm start nothing is carried (``None`` passes
        through)."""
        if not self.cfg.powersgd_warm_start or extra is None:
            return momentum, error, extra
        r_old, r_new = self.rank, new.rank
        if r_new == r_old:
            return momentum, error, extra
        if r_new < r_old:
            return momentum, error, extra[:, :r_new].contiguous()
        fresh = new.init_extra_state(extra.device)  # [m, r_new]
        return momentum, error, torch.cat([extra, fresh[:, r_old:]], dim=1)

    def download_floats(self) -> int:
        # the applied delta is exactly the pair (P_hat, Q_new)
        return self.rank * (self.n + self.m)

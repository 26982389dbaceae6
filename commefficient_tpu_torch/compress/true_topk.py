"""``true_topk`` — server-side top-k of the exact dense aggregate (the
reference's ``compress/true_topk.py``).

Clients transmit dense gradients (uplink D floats); the server runs
momentum and lr-scaled virtual error feedback on dense ``[D]`` vectors and
extracts a top-k update:

    m = rho * m + agg;  e += lr * m;  delta = TopK(e, k);  e -= delta

Without error feedback it extracts ``TopK(m, k)`` and applies it times lr.

The same algebra runs on slices (``_sharded_algebra``) in two rounds:
under ``aggregate='sparse'`` (``server_update_sparse``: the transmit sum
is reduce-scattered, each rank keeps its ``[padded_dim / W]`` slice of
momentum and error, selects with the sharded threshold and contributes
its <= k candidate pairs to one W*k pair all_gather), and under FSDP
(``fsdp_update``, where the params are sliced too). Both need the
threshold top-k (Config refuses the others there).
"""

from __future__ import annotations

import warnings

import torch

from commefficient_tpu_torch.compress.base import KIND_DENSE, Compressor
from commefficient_tpu_torch.compress.registry import register
from commefficient_tpu_torch.ops.collectives import all_gather_pairs
from commefficient_tpu_torch.ops.topk import (
    compact_nonzero,
    topk_threshold_sharded,
)


@register("true_topk")
class TrueTopkCompressor(Compressor):
    allowed_error_types = ("none", "virtual")
    supports_fused_clients = True
    supports_fsdp = True
    # aggregate='sparse': reduce-scatter the dense transmit, run the slice
    # algebra on sharded momentum/error, exchange only the <= W*k selected
    # pairs. It moves the server state onto the ranks, so 'auto' never
    # picks it (explicit only)
    supports_sparse_aggregate = True
    sparse_aggregate_shards_state = True
    dense_delta = False  # the delta already has <= k nonzeros

    def _dampening_warnings(self, dampen: bool) -> None:
        cfg = self.cfg
        if (cfg.momentum_dampening is None
                and (cfg.virtual_momentum > 0 or cfg.local_momentum > 0)):
            warnings.warn(
                "momentum_dampening=AUTO resolves to False for true_topk "
                "(the reference's four-corner evidence: unmasked 0.8923 vs "
                "masked 0.8595 at tuned lr). The original implementation "
                "masks momentum here — pass momentum_dampening=True "
                "explicitly for its behaviour.")

    def server_state_kinds(self):
        # momentum allocated even at rho = 0: the algebra runs
        # m = rho * m + agg unconditionally, as the reference does
        virtual = self.cfg.error_type == "virtual"
        return (KIND_DENSE, KIND_DENSE if virtual else None)

    def server_update(self, momentum, error, extra, agg, lr: float,
                      step: int, draw=None):
        cfg = self.cfg
        dampen = self.resolved_dampening()
        m = cfg.virtual_momentum * momentum + agg
        if cfg.error_type == "virtual":
            e = error + lr * m
            update = self.topk(e, cfg.k)
            e = e - update  # the extracted coordinates' error is 0
            if cfg.error_decay != 1.0:
                e = cfg.error_decay * e
            delta = update
        else:
            e = error
            update = self.topk(m, cfg.k)
            delta = lr * update
        if dampen:
            # the mask is the UNSCALED selection's support (lr may be 0)
            m = torch.where(update != 0, 0.0, m)
        return delta, m, e, extra

    def _sharded_algebra(self, m_in, e_in, agg_sh, lr: float, *, group):
        """The server algebra on this rank's coordinate slice, shared by
        the FSDP round and the sparse-aggregate round: momentum, lr-scaled
        virtual error feedback and the sharded threshold selection.
        Returns ``(delta_sh, new_m_sh, new_e_sh)``."""
        cfg = self.cfg
        dampen = self.resolved_dampening()
        m = cfg.virtual_momentum * m_in + agg_sh
        if cfg.error_type == "virtual":
            e = e_in + lr * m
            upd = topk_threshold_sharded(e, cfg.k, group)
            e = e - upd  # the extracted coordinates' error is 0
            if cfg.error_decay != 1.0:
                e = cfg.error_decay * e
            delta_sh = upd
        else:
            e = e_in
            # the mask is the UNSCALED selection's support (lr may be 0)
            upd = topk_threshold_sharded(m, cfg.k, group)
            delta_sh = lr * upd
        if dampen:
            m = torch.where(upd != 0, 0.0, m)
        return delta_sh, m, e

    def fsdp_update(self, p_sh, m_in, e_in, local, lr: float, *, group,
                    W: int, d: int, dp: int, S: int):
        agg_sh = group.reduce_scatter(
            torch.nn.functional.pad(local, (0, dp - d))) / W
        delta_sh, m, e = self._sharded_algebra(m_in, e_in, agg_sh, lr,
                                               group=group)
        return p_sh - delta_sh, m, e, agg_sh

    def server_update_sparse(self, momentum, error, extra, agg_sh,
                             lr: float, step: int, *, group, d: int):
        delta_sh, m, e = self._sharded_algebra(momentum, error, agg_sh, lr,
                                               group=group)
        # each rank owns a disjoint range, so its <= k selected coordinates
        # never meet another rank's: one W*k pair all_gather replaces the
        # dense [D] exchange
        S = agg_sh.shape[0]
        loc, val = compact_nonzero(delta_sh, self.cfg.k)
        gidx = torch.clamp(group.rank * S + loc, max=d - 1)  # pads clip
        g_idx, g_val = all_gather_pairs(gidx, val, group,
                                        segments=self.overlap_segments)
        return g_idx, g_val, m, e, extra

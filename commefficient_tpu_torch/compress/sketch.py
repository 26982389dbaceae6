"""``sketch`` — FetchSGD: CountSketch compression with sketched server state
(the reference's ``compress/sketch.py``).

Each device sketches its summed transmit ONCE (``device_encode``); the sum
of tables is the sketch of the sum (linearity); the server's momentum and
error feedback run in sketch space (FetchSGD Algorithm 1,
arXiv:2007.07682) before a top-k unsketch extracts the applied update:

    S_u = rho * S_u + S(agg);  S_e += lr * S_u
    delta = TopK(U(S_e), k);   S_e -= S(delta);  w -= delta

Two decodes of the same algebra. The dense one (``server_update``) runs
the whole extraction on every device. The sharded one
(``server_update_sharded``) keeps the tables replicated and splits only
the EXTRACTION: each rank of the worker group estimates its slice of the
coordinates (``estimate_at_range``, K4's range form: the slice is a
coordinate range, so no index array is built), the global top-<=k
threshold costs two scalar collectives per bisection step, each rank
compacts its <= k selected entries into a fixed buffer, and one ~size*k
pair all_gather replaces the full-[D] decode. The zero-heavy-hitter error feedback sums
the ranks' slice sketches (linearity), and the round applies the gathered
pairs as a k-sparse scatter: no [D] estimate, delta or re-sketch exists.
"""

from __future__ import annotations

import warnings

import torch

from commefficient_tpu_torch.compress.base import KIND_TABLE, Compressor
from commefficient_tpu_torch.compress.registry import register
from commefficient_tpu_torch.ops.collectives import all_gather_pairs
from commefficient_tpu_torch.ops.countsketch import (
    estimate_at,
    estimate_at_range,
    sketch_sparse,
    sketch_vec,
)
from commefficient_tpu_torch.ops.topk import (
    compact_nonzero,
    topk_threshold_sharded,
)


@register("sketch")
class SketchCompressor(Compressor):
    allowed_error_types = ("none", "virtual")
    needs_sketch_spec = True
    supports_sharded_decode = True
    dense_delta = False  # the unsketched delta already has <= k nonzeros

    # tables are stored f32 in this slice (bf16 storage is ROADMAP A10), so
    # the reference's "f32 algebra on upcast tables" casts are no-ops here
    @staticmethod
    def _up(table):
        return None if table is None else table.to(torch.float32)

    @staticmethod
    def _down(table):
        return None if table is None else table.to(torch.float32)

    def _dampening_warnings(self, dampen: bool) -> None:
        if dampen:
            warnings.warn(
                "momentum_dampening in sketch mode subtracts the sketch of "
                "ESTIMATED momentum values; the estimate noise injected "
                "into the momentum sketch every round destabilizes "
                "training at paper-scale settings in the reference's "
                "experiments. FetchSGD's Algorithm 1 does not mask "
                "sketched momentum — prefer momentum_dampening=False here "
                "(dense modes mask exactly and are unaffected).",
                stacklevel=3)

    def server_state_kinds(self):
        cfg = self.cfg
        return (KIND_TABLE if cfg.virtual_momentum > 0 else None,
                KIND_TABLE if cfg.error_type == "virtual" else None)

    def device_encode(self, local_sum):
        return sketch_vec(self.spec, local_sum)

    def server_update(self, momentum, error, agg, lr: float):
        cfg, spec = self.cfg, self.spec
        dampen = self.resolved_dampening()
        rho = cfg.virtual_momentum
        agg, momentum, error = map(self._up, (agg, momentum, error))
        m = rho * momentum + agg if rho > 0 else agg
        if cfg.error_type == "virtual":
            e = error + lr * m
            update = self.unsketch(spec, e, cfg.k)  # dense, <= k nonzeros
            e = e - sketch_vec(spec, update)  # zero the extracted HH
            if cfg.error_decay != 1.0:
                e = cfg.error_decay * e
            delta = update
        else:
            e = error
            update = self.unsketch(spec, m, cfg.k)
            delta = lr * update
        if dampen and rho > 0:
            # zero the momentum sketch at the update's <= k support: the
            # sketch of the momentum's point estimates there
            hh_idx, hh_val = compact_nonzero(update, cfg.k)
            m_at_hh = torch.where(hh_val != 0, estimate_at(spec, m, hh_idx),
                                  0.0)
            m = m - sketch_sparse(spec, hh_idx, m_at_hh)
        new_m = m if rho > 0 else momentum
        return delta, self._down(new_m), self._down(e)

    def server_update_sharded(self, momentum, error, agg, lr: float, *,
                              group, d: int):
        cfg, spec = self.cfg, self.spec
        dampen = self.resolved_dampening()
        rho = cfg.virtual_momentum
        S = -(-d // group.size)
        start, in_range = self._slice_coords(group.rank, S, d, agg.device)
        agg, momentum, error = map(self._up, (agg, momentum, error))
        m = rho * momentum + agg if rho > 0 else agg
        sel, upd, e = self._slice_extract(m, error, lr, start, in_range,
                                          group, d)
        if dampen and rho > 0:
            # each rank estimates m at ITS selected coordinates; the sum of
            # the slice sketches is the sketch of the masked momentum. The
            # mask is the UNSCALED selection's support (lr may be 0).
            loc_d, upd_val = compact_nonzero(upd, cfg.k)
            hh_gidx = torch.clamp(start + loc_d, max=d - 1)
            m_at_hh = torch.where(upd_val != 0,
                                  estimate_at(spec, m, hh_gidx), 0.0)
            m = m - group.all_reduce_sum(sketch_sparse(spec, hh_gidx,
                                                       m_at_hh))
        new_m = m if rho > 0 else momentum
        # this rank's <= k selected entries, compacted; pads clip into
        # range with val 0.0, which the apply scatter adds as a no-op
        loc, val = compact_nonzero(sel, cfg.k)
        gidx = torch.clamp(start + loc, max=d - 1)
        g_idx, g_val = all_gather_pairs(gidx, val, group)
        return g_idx, g_val, self._down(new_m), self._down(e)

    @staticmethod
    def _slice_coords(rank: int, S: int, d: int, device):
        """``(start, in_range)``: the first global coordinate of this
        rank's slice ``min(start + arange(S), d - 1)``, and the f32 mask of
        the slice's coordinates that lie inside [0, d)."""
        start = rank * S
        return start, (torch.arange(start, start + S, device=device)
                       < d).to(torch.float32)

    def _slice_extract(self, m, error, lr, start, in_range, group, d):
        """Estimate this rank's slice (``estimate_at_range`` over
        ``in_range.numel()`` coordinates from ``start``), select the
        global top-<=k (``topk_threshold_sharded``) and run the zero-HH
        error feedback (the sum over ranks of the slice sketches of the
        selection is the sketch of the whole extracted update). Returns
        ``(sel, upd, new_error)``: ``sel`` the applied slice (lr-scaled
        without error feedback), ``upd`` the unscaled selection."""
        cfg, spec = self.cfg, self.spec
        S = in_range.numel()
        if cfg.error_type == "virtual":
            e = error + lr * m
            est = estimate_at_range(spec, e, start, S) * in_range
            upd = topk_threshold_sharded(est, cfg.k, group)
            loc, val = compact_nonzero(upd, cfg.k)
            gidx = torch.clamp(start + loc, max=d - 1)
            e = e - group.all_reduce_sum(sketch_sparse(spec, gidx, val))
            if cfg.error_decay != 1.0:
                e = cfg.error_decay * e
            return upd, upd, e
        est = estimate_at_range(spec, m, start, S) * in_range
        upd = topk_threshold_sharded(est, cfg.k, group)
        return lr * upd, upd, error

    def upload_floats(self) -> int:
        """The REALIZED table size ``r * c_actual``; warns when the blocked
        layout inflates the request by more than 25%."""
        r, c_actual = self.spec.table_shape
        up = r * c_actual
        if up > 1.25 * self.cfg.num_rows * self.cfg.num_cols:
            warnings.warn(
                f"realized sketch table ({up} floats) exceeds the requested "
                f"num_rows*num_cols ({self.cfg.num_rows * self.cfg.num_cols})"
                " by >25%: raise num_cols or chunk size m.", stacklevel=2)
        return up

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
Under ``aggregate='sparse'`` (``_ride_pair_exchange``) that error
feedback rides the pair exchange instead: the ranks' <= k selected pairs
are all-gathered and ONE local ``sketch_sparse`` (K1) of all of them
replaces the sum over the group of per-rank slice sketches (the same
table up to f32 summation order). FSDP (``fsdp_update``) runs the same
slice extraction after the sum of the tables, on sliced params.

bf16 tables (``sketch_table_dtype``): the tables are STORED, summed over
the group and carried in ``spec.table_dtype``, while every piece of server
algebra upcasts them to f32 first (``_up``) and rounds only what it stores
back (``_down``): "bf16 tables, f32 accumulation". The error feedback's
re-sketch of the extracted update accumulates into an f32 table
(``_spec_acc``), with the operand still rounded to ``spec.dtype``; the
sharded decode's slice sketches travel in the storage type, as the
reference's psum payload does.
"""

from __future__ import annotations

import warnings
from dataclasses import replace

import torch

from commefficient_tpu_torch.compress.base import (
    KIND_TABLE,
    Compressor,
    sqnorm,
)
from commefficient_tpu_torch.compress.registry import register
from commefficient_tpu_torch.ops.collectives import all_gather_pairs
from commefficient_tpu_torch.ops.countsketch import (
    estimate_at,
    estimate_at_range,
    scrambled_sparse,
    sketch_sparse,
    sketch_vec,
    table_sqnorm_estimate,
    topk_scatter,
)
from commefficient_tpu_torch.ops.topk import (
    compact_nonzero,
    topk_threshold_dense,
    topk_threshold_sharded,
)


@register("sketch")
class SketchCompressor(Compressor):
    allowed_error_types = ("none", "virtual")
    needs_sketch_spec = True
    supports_sharded_decode = True
    supports_fused_clients = True
    supports_fused_backward = True
    supports_fsdp = True
    # aggregate='sparse': the [r, c] table sum stays (it is O(r*c), not
    # O(D)), but the error feedback's re-sketch rides the pair exchange.
    # It changes the f32 summation order, so 'auto' never picks it
    supports_sparse_aggregate = True
    dense_delta = False  # the unsketched delta already has <= k nonzeros

    # the f32 algebra on upcast tables; both casts are no-ops for the f32
    # default
    @staticmethod
    def _up(table):
        return None if table is None else table.to(torch.float32)

    def _down(self, table):
        return None if table is None else table.to(self.spec.table_dtype)

    @property
    def _spec_acc(self):
        """The spec with f32 storage: the interior re-sketch of the error
        feedback accumulates at f32, so only stored state and the group
        sum's payload pay the bf16 rounding (equal to ``spec`` for the f32
        default)."""
        return replace(self.spec, table_dtype=torch.float32)

    @property
    def _ride_pair_exchange(self) -> bool:
        """True when the sharded decode's re-sketches ride the pair
        exchange (explicit ``aggregate='sparse'``; Config validated the
        threshold top-k and the sharded decode, and refuses it under
        FSDP)."""
        return self.cfg.aggregate == "sparse"

    def _resketch_sum(self, gidx, val, group):
        """The sketch, in the storage type, of the pairs of every rank:
        the sum over the group of the per-rank ``sketch_sparse`` tables,
        or, riding the pair exchange, one ``sketch_sparse`` of all the
        gathered pairs."""
        spec = self.spec
        if self._ride_pair_exchange:
            g_i, g_v = all_gather_pairs(gidx, val, group,
                                        segments=self.overlap_segments)
            return sketch_sparse(spec, g_i, g_v, table_dtype=spec.table_dtype)
        return group.all_reduce_sum(sketch_sparse(
            spec, gidx, val, table_dtype=spec.table_dtype))

    def validate_fsdp(self) -> None:
        if self.cfg.momentum_dampening:
            raise NotImplementedError(
                "sketch momentum dampening is gated as unstable in the "
                "replicated round already; not offered under fsdp")

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

    def encode_grad_table(self, table):
        """The sketch-fused backward's encode: the device's summed
        transmit is already an f32 table (the taps' segment sketches);
        only the storage cast of the group sum's payload remains."""
        return self._down(table)

    def server_update(self, momentum, error, extra, agg, lr: float,
                      step: int):
        cfg, spec = self.cfg, self.spec
        dampen = self.resolved_dampening()
        rho = cfg.virtual_momentum
        agg, momentum, error = map(self._up, (agg, momentum, error))
        m = rho * momentum + agg if rho > 0 else agg
        if cfg.error_type == "virtual":
            e = error + lr * m
            update = self.unsketch(spec, e, cfg.k)  # dense, <= k nonzeros
            # zero the extracted HH; the re-sketch accumulates at f32
            e = e - sketch_vec(self._spec_acc, update)
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
        return delta, self._down(new_m), self._down(e), extra

    def server_update_sharded(self, momentum, error, extra, agg, lr: float,
                              step: int, *, group, d: int):
        cfg, spec = self.cfg, self.spec
        dampen = self.resolved_dampening()
        rho = cfg.virtual_momentum
        _, S = self.shard_slice(group.rank, group.size, d)
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
            m = m - self._resketch_sum(hh_gidx, m_at_hh, group)
        new_m = m if rho > 0 else momentum
        # this rank's <= k selected entries, compacted; pads clip into
        # range with val 0.0, which the apply scatter adds as a no-op
        loc, val = compact_nonzero(sel, cfg.k)
        gidx = torch.clamp(start + loc, max=d - 1)
        g_idx, g_val = all_gather_pairs(gidx, val, group,
                                        segments=self.overlap_segments)
        return g_idx, g_val, self._down(new_m), self._down(e), extra

    @staticmethod
    def shard_slice(rank: int, size: int, d: int):
        """``(start, S)``: the slice of coordinates that rank ``rank`` of
        ``size`` decodes (the sharded decode, FSDP's extraction), ``S =
        ceil(d / size)`` from ``start = rank * S``; K4's range form
        estimates it each round, so the prewarm builds its plan."""
        S = -(-d // size)
        return rank * S, S

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
            # the group sum's payload is in the storage type (the
            # reference's psum); the subtraction promotes back to f32
            e = e - self._resketch_sum(gidx, val, group)
            if cfg.error_decay != 1.0:
                e = cfg.error_decay * e
            return upd, upd, e
        est = estimate_at_range(spec, m, start, S) * in_range
        upd = topk_threshold_sharded(est, cfg.k, group)
        return lr * upd, upd, error

    def fsdp_update(self, p_sh, m_in, e_in, local, lr: float, *, group,
                    W: int, d: int, dp: int, S: int):
        """FSDP: the tables stay whole on every rank (the sum over the
        group of this rank's table, over W); each rank extracts its own
        coordinate slice (``_slice_extract``, K4's range form on the card)
        and applies it to its params slice."""
        rho = self.cfg.virtual_momentum
        table = sketch_vec(self.spec, local)  # the storage type: the payload
        agg = self._up(group.all_reduce_sum(table)) / W
        start, in_range = self._slice_coords(group.rank, S, d, p_sh.device)
        m_in, e_in = self._up(m_in), self._up(e_in)
        m = rho * m_in + agg if rho > 0 else agg
        delta_sh, _, e = self._slice_extract(m, e_in, lr, start, in_range,
                                             group, d)
        new_m = m if rho > 0 else m_in
        return p_sh - delta_sh, self._down(new_m), self._down(e), agg

    # -- telemetry -------------------------------------------------------------
    # the dense aggregate never exists here (device_encode runs before the
    # sum over the group), so the norms are AMS estimates of the tables:
    # K3 on the card, no unsketch, no [D] transient
    def _agg_sqnorm(self, agg):
        return table_sqnorm_estimate(agg)

    def _error_sqnorm(self, error):
        return None if error is None else table_sqnorm_estimate(error)

    def fidelity(self, *, agg, delta, momentum, error, extra, new_momentum,
                 lr) -> dict:
        """The round trip's relative estimation error at the applied
        update's own support: ``delta`` (at most k nonzeros) compacted,
        sketched into a fresh f32 table (``sketch_sparse``, K1) and
        re-estimated there (``estimate_at``, K4's index form), reported as
        ``||est - delta|| / ||delta||`` over the support: the table's
        collision noise at this round's k/c occupancy."""
        idx, val = compact_nonzero(delta, self.cfg.k)
        return self._fidelity_at(idx, val)

    def fidelity_sparse(self, *, idx, val, lr) -> dict:
        """``fidelity`` of the sharded decode, whose update already is the
        gathered ``(idx, val)`` candidates (``val == 0`` padding)."""
        return self._fidelity_at(idx, val)

    def _fidelity_at(self, idx, val) -> dict:
        spec = self.spec
        rt = estimate_at(spec, sketch_sparse(spec, idx, val), idx)
        num = torch.sqrt(sqnorm(torch.where(val != 0, rt - val, 0.0)))
        den = torch.sqrt(sqnorm(val))
        return {"sketch_est_rel_err": num / torch.clamp(den, min=1e-30)}

    # -- rung migration (the control/ compression ladder) ---------------------
    def migrate_state(self, new, momentum, error, extra):
        """Sketch-mode rung migration. A ``k``-only switch is free: the
        tables depend on the spec's geometry, not on k (k only selects
        how many heavy hitters the decode extracts), so an identical
        geometry (``table_shape``, ``c``, ``num_blocks``) passes the SAME
        tensors through. A ``num_cols`` switch changes the layout, and a
        table sketched under one layout means nothing under another: each
        ``[r, c_old]`` table is decoded to its top-k support by this
        rung's decode (``self.unsketch`` at ``cfg.k``: K2 and the rung's
        top-k), compacted (``compact_nonzero``) and RE-SKETCHED into the
        new layout (``sketch_sparse`` at the new spec, K1), stored in the
        new spec's table type: ``new_table = S_new(U_old(table, k))``. By
        the linearity of both maps this carries exactly the decodable
        signal; the sub-threshold residual the old table held is dropped
        (a controlled leak, like ``error_decay``): there is no lossless
        map between CountSketch geometries."""
        old_spec, new_spec = self.spec, new.spec
        if (new_spec.table_shape == old_spec.table_shape
                and new_spec.c == old_spec.c
                and new_spec.num_blocks == old_spec.num_blocks):
            return momentum, error, extra
        k = self.cfg.k

        def move(table):
            if table is None:
                return None
            dense = self.unsketch(old_spec, table, k)
            idx, val = compact_nonzero(dense, k)
            return sketch_sparse(new_spec, idx, val,
                                 table_dtype=new_spec.table_dtype)

        return move(momentum), move(error), extra

    def warm_migration(self, device) -> None:
        """A ``num_cols`` migration's ops between K2 and K1, once, on a
        scratch ``[d]`` vector at this rung's ``k``: the decode's selection
        (``self.unsketch`` after its K2), ``compact_nonzero`` and
        ``sketch_sparse``'s scatter and scramble. No K1 or K2 launch, no
        state touched."""
        d, k = self.spec.d, self.cfg.k
        est = torch.zeros(d, dtype=torch.float32, device=device)
        est[::max(1, d // k)] = 1.0
        select = (topk_threshold_dense if self.cfg.topk_method == "threshold"
                  else topk_scatter)
        idx, val = compact_nonzero(select(est, k), k)
        scrambled_sparse(self.spec, idx, val)

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

    def upload_bytes_per_float(self) -> int:
        """2 when the tables, the upload, are stored bfloat16, else 4."""
        return self.spec.table_dtype.itemsize

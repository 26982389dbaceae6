"""``sketch`` — FetchSGD: CountSketch compression with sketched server state
(the reference's ``compress/sketch.py``, dense decode).

Each device sketches its summed transmit ONCE (``device_encode``); the sum
of tables is the sketch of the sum (linearity); the server's momentum and
error feedback run in sketch space (FetchSGD Algorithm 1,
arXiv:2007.07682) before a top-k unsketch extracts the applied update:

    S_u = rho * S_u + S(agg);  S_e += lr * S_u
    delta = TopK(U(S_e), k);   S_e -= S(delta);  w -= delta
"""

from __future__ import annotations

import warnings

import torch

from commefficient_tpu_torch.compress.base import KIND_TABLE, Compressor
from commefficient_tpu_torch.compress.registry import register
from commefficient_tpu_torch.ops.countsketch import sketch_vec


@register("sketch")
class SketchCompressor(Compressor):
    allowed_error_types = ("none", "virtual")
    needs_sketch_spec = True
    dense_delta = False  # the unsketched delta already has <= k nonzeros

    # tables are stored f32 in this slice (bf16 storage is ROADMAP A10), so
    # the reference's "f32 algebra on upcast tables" casts are no-ops here
    @staticmethod
    def _up(table):
        return None if table is None else table.to(torch.float32)

    @staticmethod
    def _down(table):
        return None if table is None else table.to(torch.float32)

    def server_state_kinds(self):
        cfg = self.cfg
        return (KIND_TABLE if cfg.virtual_momentum > 0 else None,
                KIND_TABLE if cfg.error_type == "virtual" else None)

    def device_encode(self, local_sum):
        return sketch_vec(self.spec, local_sum)

    def server_update(self, momentum, error, agg, lr: float):
        cfg, spec = self.cfg, self.spec
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
            delta = lr * self.unsketch(spec, m, cfg.k)
        new_m = m if rho > 0 else momentum
        return delta, self._down(new_m), self._down(e)

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

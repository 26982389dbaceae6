"""The round audit: what round 0 computed, allocated and moved between
devices, measured as it ran (the port's counterpart of the reference's
``commefficient_tpu/telemetry/xla_audit.py``, ``CompiledRoundAudit``).

The reference reads these figures off the compiled XLA round: its cost and
memory analyses and a walk of its HLO for collectives. The port runs eager
PyTorch, with no compiled round to read, so it measures the first round
this process dispatches (round 0, or the resumed round), as it runs, with
no extra round and no copy of the state (under the buffered-async engine
the first update: its cohort launches and its apply, ``engine: "async"``
with the ``async`` block of ``buffer``, ``concurrency`` and
``staleness_exponent``):

* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` around the
  round's dispatch. It counts matmul and convolution FLOPs only (the
  hand-written sketch kernels, the top-k and every elementwise op count
  nothing); ``bytes_accessed`` and ``transcendentals`` are null, since
  torch counts neither. Torch's formula for a convolution's backward
  counts a grouped convolution's weight gradient ``groups`` times over
  (it drops the groups there), and the batched client step's
  convolutions are grouped (``vmap`` over per-client weights makes one
  group a client): ``conv_backward_flop`` here counts that term as the
  forward's products;
* ``memory.peak_hbm_bytes``: ``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats`` at the round's start: the caching
  allocator's peak of the whole process over the round (state, data and
  the round's temporaries), tracked on the host, so no sync; null on the
  CPU;
* ``collectives``: the worker group's own calls during the round
  (``parallel/mesh.py``'s ``CollectiveCounter``: per op the count and the
  per-rank result bytes, the reference's convention), cross-checked
  against the ``CommLedger``'s upload bytes with the reference's
  tolerance and bounds (``wk_bound`` on the sharded decode,
  ``sparse_agg_bound`` under sparse aggregation, the ``overlap`` block
  under layerwise overlap). One device has no group collectives, so
  ``collectives_present`` is false there;
* ``predicted``: the card's dense bf16 peak from ``PEAK_FLOPS`` (keyed by
  ``torch.cuda.get_device_name()``; another card falls back to the H100's
  figure, flagged ``peak_flops_assumed``) and the FLOP floor of a round.

``perf_report.json`` has the reference's fields, so its
``scripts/check_telemetry_schema.py`` validates it. The ``xla/*`` names
of the scalars are the reference's schema names. Nothing here changes a
value: the counter and the allocator's statistics are host bookkeeping,
and ``FlopCounterMode`` calls each op as it is.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional

import torch

# dense bf16 tensor-core peak (FLOP/s) by torch.cuda.get_device_name():
# NVIDIA's H100 SXM data sheet, without sparsity, at its 700 W limit
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
_FALLBACK_PEAK = PEAK_FLOPS["NVIDIA H100 80GB HBM3"]

# the ledger-vs-collectives slop: the loss, diagnostics and threshold
# bisection all-reduces are scalars, a few bytes each
SCALAR_COLLECTIVE_SLOP_BYTES = 4096

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "collective-permute")

_COST_REASON = ("torch's FlopCounterMode counts matmul and convolution "
                "FLOPs only; it counts neither bytes accessed nor "
                "transcendentals")


def conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride,
                       padding, dilation, transposed, output_padding,
                       groups, output_mask, out_shape=None, **kwargs) -> int:
    """``aten.convolution_backward``'s FLOPs: torch's formula for the input
    gradient, and for the weight gradient the forward's own count (the
    same products, summed over the batch instead of the channels), which
    ``w_shape``'s per-group channels keep right for a grouped
    convolution."""
    from torch.utils.flop_counter import conv_backward_flop as torch_formula
    from torch.utils.flop_counter import conv_flop_count

    flops = 0
    if output_mask[0]:
        flops += torch_formula(grad_out_shape, x_shape, w_shape, bias,
                               stride, padding, dilation, transposed,
                               output_padding, groups, [True, False],
                               out_val=out_shape)
    if output_mask[1]:
        flops += conv_flop_count(list(x_shape), list(w_shape),
                                 list(grad_out_shape), transposed)
    return flops


def flop_counter():
    """A ``FlopCounterMode`` with the grouped weight gradient counted
    right (``conv_backward_flop``)."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: conv_backward_flop})


def chip_peak_flops(device) -> tuple:
    """``(peak bf16 FLOP/s, device kind, fallback used)`` for ``device``;
    ``(None, "cpu", None)`` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, device.type, None
    kind = torch.cuda.get_device_name(device)
    if kind in PEAK_FLOPS:
        return PEAK_FLOPS[kind], kind, False
    return _FALLBACK_PEAK, kind, True


def ledger_tolerance(upload_bytes: int, *, sharded: bool = False,
                     workers: int = 0, k: int = 0) -> int:
    """The tolerance of the ledger-vs-collectives delta: the scalar slop,
    plus on the sharded sketch decode its known extra traffic (one
    error-feedback re-sketch all-reduce of table size and the idx + val
    candidate gathers of <= W*k pairs each)."""
    tol = SCALAR_COLLECTIVE_SLOP_BYTES
    if sharded:
        tol += int(upload_bytes) + 8 * int(workers) * int(k)
    return tol


def exposed_collective_ms(spans, audit=None) -> float:
    """The ``xla/exposed_collective_ms`` scalar: the spans' un-overlapped
    collective wait (``PhaseSpans.collective_exposure_ms``), pinned to 0.0
    when the audited round holds no collective (on one device the
    dispatch span waits just as long on pure compute); without an audit
    the spans' reading stands alone."""
    if spans is None:
        return 0.0
    if audit is not None and not audit.collectives_present:
        return 0.0
    return float(spans.collective_exposure_ms())


class RoundAudit:
    """One measured round; ``report()`` is the ``perf_report.json``
    payload, ``write()`` persists it, ``scalars()`` are the ``xla/*``
    scalars of the audited round. The constructor takes what
    ``CompiledRoundAudit``'s does (no multihost block: the port runs no
    multihost mesh)."""

    def __init__(self, *, cost: dict, memory: dict, collectives: dict,
                 engine: str = "replicated", mode: str = "",
                 sketch_decode: Optional[str] = None,
                 aggregate: Optional[str] = None, grad_size: int = 0,
                 workers_mesh: int = 1,
                 ledger_up_bytes: Optional[int] = None,
                 wk_bound: Optional[int] = None,
                 sparse_agg_bound: Optional[int] = None,
                 sparse_agg_exemption: Optional[str] = None,
                 tolerance_bytes: Optional[int] = None,
                 overlap_info: Optional[dict] = None,
                 async_info: Optional[dict] = None,
                 peak=(None, None, None), step: int = 0):
        self.cost = cost
        self.async_info = dict(async_info) if async_info else None
        self.memory = memory
        self.engine = engine
        self.mode = mode
        self.sketch_decode = sketch_decode
        self.aggregate = aggregate
        self.grad_size = int(grad_size)
        self.workers_mesh = int(workers_mesh)
        self.overlap_info = dict(overlap_info) if overlap_info else None
        self.peak = peak
        self.step = int(step)
        coll = dict(collectives)
        coll["wk_bound"] = wk_bound
        coll["sparse_agg_bound"] = sparse_agg_bound
        coll["sparse_agg_exemption"] = sparse_agg_exemption
        coll["ledger_up_bytes"] = ledger_up_bytes
        if ledger_up_bytes is not None:
            delta = coll["total_bytes"] - int(ledger_up_bytes)
            tol = (tolerance_bytes if tolerance_bytes is not None
                   else SCALAR_COLLECTIVE_SLOP_BYTES)
            coll["delta_bytes"] = delta
            coll["tolerance_bytes"] = int(tol)
            coll["within_tolerance"] = abs(delta) <= int(tol)
        self.collectives = coll

    @property
    def collectives_present(self) -> bool:
        """Whether the audited round made any collective call."""
        return any(v.get("count", 0) > 0
                   for v in self.collectives.get("ops", {}).values())

    def scalars(self) -> Dict[str, float]:
        """The ``xla/*`` scalars of the audit (only the measured ones)."""
        out: Dict[str, float] = {
            "xla/collective_bytes": float(self.collectives["total_bytes"]),
        }
        if self.collectives.get("delta_bytes") is not None:
            out["xla/ledger_delta_bytes"] = float(
                self.collectives["delta_bytes"])
        if self.cost.get("flops") is not None:
            out["xla/audited_flops"] = float(self.cost["flops"])
        if self.memory.get("peak_hbm_bytes") is not None:
            out["xla/peak_hbm_bytes"] = float(self.memory["peak_hbm_bytes"])
        return out

    def report(self, *, generated_by: str, cfg=None) -> dict:
        from commefficient_tpu_torch.telemetry import (
            SCHEMA_VERSION,
            jsonable_tree,
        )
        from commefficient_tpu_torch.telemetry.ledger import run_metadata

        peak, kind, assumed = self.peak
        rec = {
            "schema_version": SCHEMA_VERSION,
            "kind": "perf_report",
            "generated_by": generated_by,
            "engine": self.engine,
            "mode": self.mode,
            "sketch_decode": self.sketch_decode,
            "aggregate": self.aggregate,
            "grad_size": self.grad_size,
            "workers_mesh": self.workers_mesh,
            "audited_step": self.step,
            "cost": self.cost,
            "memory": self.memory,
            "collectives": self.collectives,
            "predicted": {
                "peak_flops": peak, "device_kind": kind,
                "peak_flops_assumed": assumed,
                # the round can never beat its counted FLOPs at peak
                "compute_bound_sec_per_round": (
                    self.cost["flops"] / peak
                    if peak and self.cost.get("flops") is not None
                    else None),
            },
            # no compiled module: the collectives are the group's calls
            "hlo_unavailable_reason": None,
            "meta": run_metadata(cfg),
        }
        if self.overlap_info is not None:
            rec["overlap"] = dict(self.overlap_info)
        if self.async_info is not None:
            rec["async"] = dict(self.async_info)
        return jsonable_tree(rec)

    def write(self, logdir: str, *, generated_by: str, cfg=None) -> str:
        """Write ``perf_report.json`` into ``logdir``; returns the path."""
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, "perf_report.json")
        with open(path, "w") as f:
            json.dump(self.report(generated_by=generated_by, cfg=cfg), f,
                      indent=2, allow_nan=False)
        return path

    def describe(self) -> str:
        """One console line."""
        c, m = self.cost, self.memory
        flops = ("?" if c.get("flops") is None
                 else f"{c['flops'] / 1e9:.3f} GFLOP")
        hbm = ("?" if m.get("peak_hbm_bytes") is None
               else f"{m['peak_hbm_bytes'] / 2**20:.1f} MiB")
        coll = self.collectives
        ok = coll.get("within_tolerance")
        return (
            f"round audit [{self.engine}/{self.mode}] round {self.step}: "
            f"{flops} (matmul+conv), peak memory {hbm}, collectives "
            f"{coll['total_bytes']:,} B vs ledger "
            f"{coll.get('ledger_up_bytes', '?')} B"
            + ("" if ok is None else
               f" (delta {coll['delta_bytes']:+,} B, "
               f"{'within' if ok else 'OUTSIDE'} tolerance)"))


class RoundAuditArm:
    """Measures the first round a session dispatches and writes its
    report: the session calls ``measure(step)`` around that round's
    dispatch and ``finish()`` right after it. ``writer`` gets the
    ``xla/*`` scalars at the audited step."""

    def __init__(self, session, cfg, writer, generated_by: str):
        self.session = session
        self.cfg = cfg
        self.writer = writer
        self.generated_by = generated_by
        self.armed = True
        self._measured: Optional[dict] = None

    @contextlib.contextmanager
    def measure(self, step: int):
        self.armed = False
        sess = self.session
        dev = sess.device
        on_card = dev.type == "cuda"
        counter = getattr(sess.group, "counter", None)
        if counter is not None:
            counter.reset()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        flop_mode = flop_counter()
        with flop_mode:
            yield
        mem_reason = None
        peak = None
        if on_card:
            peak = int(torch.cuda.max_memory_allocated(dev))
        else:
            mem_reason = ("the CPU has no CUDA caching allocator: torch "
                          "tracks no peak there")
        self._measured = dict(
            step=int(step),
            cost={"flops": float(flop_mode.get_total_flops()),
                  "bytes_accessed": None, "transcendentals": None,
                  "unavailable_reason": _COST_REASON},
            memory={"argument_bytes": None, "output_bytes": None,
                    "temp_bytes": None, "alias_bytes": None,
                    "generated_code_bytes": None, "peak_hbm_bytes": peak,
                    "unavailable_reason": mem_reason or (
                        "the caching allocator gives the process's peak "
                        "over the round; XLA's argument/output/temp split "
                        "has no counterpart")},
            collectives=(counter.snapshot() if counter is not None else
                         {"ops": {}, "total_bytes": 0,
                          "max_all_gather_elems": None,
                          "max_all_reduce_elems": None}))

    def finish(self) -> Optional[RoundAudit]:
        """Build the audit of the measured round, attach it to the session
        (``last_audit``), write ``perf_report.json`` and the scalars.
        Never raises: a failed write is a console note."""
        m, self._measured = self._measured, None
        if m is None:
            return None
        sess = self.session
        cfg = self.cfg
        try:
            engine, async_info = (
                "fsdp" if cfg.fsdp else "replicated"), None
            if cfg.asyncfed_enabled:
                engine, async_info = "async", {
                    "buffer": int(cfg.async_buffer),
                    "concurrency": int(cfg.async_concurrency),
                    "staleness_exponent": float(cfg.staleness_exponent)}
            audit = RoundAudit(
                cost=m["cost"], memory=m["memory"],
                collectives=m["collectives"], engine=engine,
                async_info=async_info, peak=chip_peak_flops(sess.device),
                step=m["step"], **sess.audit_bounds())
            sess.last_audit = audit
            path = audit.write(self.writer.logdir,
                               generated_by=self.generated_by, cfg=self.cfg)
            for name, val in audit.scalars().items():
                self.writer.scalar(name, val, m["step"])
            self.writer.flush()
            print(audit.describe())
            print(f"perf report: {path}")
            return audit
        except Exception as e:  # noqa: BLE001 — the audit never stops a run
            print(f"round audit skipped ({type(e).__name__}: {e})")
            return None


__all__ = ["COLLECTIVE_OPS", "PEAK_FLOPS", "SCALAR_COLLECTIVE_SLOP_BYTES",
           "RoundAudit", "RoundAuditArm", "chip_peak_flops",
           "exposed_collective_ms", "ledger_tolerance"]

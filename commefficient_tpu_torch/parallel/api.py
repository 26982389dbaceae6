"""FederatedSession, FedModel, FedOptimizer — the reference's public API
(``parallel/api.py``), the subset the port runs.

``FederatedSession`` owns the worker group, the state and the round, and,
when the training set fits ``device_data_max_mb``, the training set itself
on the device (``maybe_attach_data``): a round then ships only sample
indices and the augment plan, and the gather and augment run on the
device before the same round runs; ``FedModel`` is the callable facade
(``fed_model(client_ids, batch)`` runs one round at the optimizer's lr)
and ``FedOptimizer`` the schedule clock (``step()``).

With a hosted client store (``--client_store host|mmap``) the session
builds the ``clientstore/`` streamer: the cohort's rows are gathered from
the host bank (ahead of the round by the pipeline's prefetch thread, or at
the dispatch), copied to the card on a stager's stream, handed to the
round as arguments, and the round's new rows written back asynchronously
(``train_round``'s ``cohort``, ``host_vel``/``host_err``).

Under the buffered-asynchronous engine (``--async_buffer K``, asyncfed/)
the rounds do not go through ``train_round``: the engine dispatches each
rung's ``async_round_fns`` pair itself and calls the session's host
entries around them (``blacklist_env``, ``control_round_start``,
``mark_dispatched``, ``host_round_stats``).
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from commefficient_tpu_torch import resolve_device
from commefficient_tpu_torch.clientstore import build_streamer
from commefficient_tpu_torch.compress import compressor_class, get_compressor
from commefficient_tpu_torch.fedsim import build_environment
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.parallel.envelope import (
    predicted_dc_max,
    stable_dc_bound,
)
from commefficient_tpu_torch.parallel.mesh import local_rank, make_worker_group
from commefficient_tpu_torch.compress.base import KIND_DENSE
from commefficient_tpu_torch.parallel.round import (
    FedState,
    build_eval_fn,
    build_round_fn,
    init_state,
    mask_classification,
    padded_dim,
    resolve_aggregation,
)
from commefficient_tpu_torch.telemetry.round_audit import (
    exposed_collective_ms,
    ledger_tolerance,
)
from commefficient_tpu_torch.telemetry.trace import (
    round_trace_id,
    trace_round_scalars,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_device(a, device) -> torch.Tensor:
    """``a`` (a numpy array, or a tensor) on ``device``; a tensor already
    there passes through as itself."""
    if torch.is_tensor(a):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: _as_device(v, device) for k, v in batch.items()}


class RoundStager:
    """Copies a round's host arrays to the card ahead of its dispatch, for
    the pipelined engine's worker thread that owns it.

    Each array goes through a ring of ``slots`` pinned host buffers per key
    (``pin_memory()`` a round would pay ``cudaHostAlloc`` every time): the
    native gather writes straight into the next buffer (``host_buffer``,
    the sampler's ``alloc``), or the array is copied in; a buffer is reused
    only once the event recorded after its last copy has completed, so a
    copy in flight is never overwritten. The copies run with
    ``non_blocking=True`` on this stager's own ``torch.cuda.Stream``, and
    one event is recorded after a round's copies; the round's dispatch makes
    the compute stream wait on it and ``record_stream``s each staged tensor
    (``FederatedSession._consume``), so the caching allocator does not hand
    the block to another stream while the round reads it."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = max(2, int(slots))
        torch.cuda.set_device(device)  # the current device is per thread
        self.stream = torch.cuda.Stream(device)
        self._rings: Dict[str, list] = {}  # key -> [[pinned, event], ...]
        self._next: Dict[str, int] = {}
        self._handed: Dict[str, torch.Tensor] = {}  # key -> last buffer

    def host_buffer(self, key: str, shape, dtype) -> np.ndarray:
        """The next pinned buffer of ``key``'s ring as a ``shape``/``dtype``
        numpy array, once its last copy has completed."""
        ring = self._rings.setdefault(key, [[None, None]
                                            for _ in range(self.slots)])
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % self.slots
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()  # the copy that read it has finished
            slot[1] = None
        tdt = torch.from_numpy(np.empty(0, dtype)).dtype
        if (slot[0] is None or slot[0].dtype != tdt
                or tuple(slot[0].shape) != tuple(shape)):
            slot[0] = torch.empty(tuple(shape), dtype=tdt, pin_memory=True)
        self._handed[key] = slot
        return slot[0].numpy()

    def pinned_bytes(self, prefix: str = "") -> int:
        """Bytes of pinned host memory the rings of keys starting with
        ``prefix`` hold."""
        return sum(slot[0].nbytes for key, ring in self._rings.items()
                   if key.startswith(prefix) for slot in ring
                   if slot[0] is not None)

    def stage(self, arrays: Dict[str, Any]):
        """``({key: device tensor}, ready event)``: each host array copied
        into its pinned buffer (unless the native gather already wrote it
        there) and from there to the card on this stager's stream."""
        pinned = {}
        for k, a in arrays.items():
            a = np.asarray(a)
            slot = self._handed.pop(k, None)
            if slot is None or not (a.flags.c_contiguous
                                    and a.ctypes.data == slot[0].data_ptr()
                                    and a.nbytes == slot[0].nbytes):
                self.host_buffer(k, a.shape, a.dtype)[...] = a
                slot = self._handed.pop(k)
            pinned[k] = (slot, a.shape)
        out = {}
        with torch.cuda.stream(self.stream):
            for k, (slot, shape) in pinned.items():
                out[k] = slot[0].reshape(shape).to(self.device,
                                                   non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        for slot, _ in pinned.values():
            slot[1] = ready
        return out, ready


def envelope_warning(d: int, c_actual: int, error_decay: float,
                     label: str = "") -> Optional[str]:
    """The reference session's d/c warning, or None: a realized ``d /
    c_actual`` above ``stable_dc_bound(error_decay)`` is outside the
    fitted stable envelope of the error feedback (``parallel/
    envelope.py``). The suggested ``num_cols`` pads the realized target by
    5%, enough that following it clears the check (the realized width
    deviates a few percent from the request). ``label`` names the ladder
    rung the spec is of ("" without a ladder)."""
    bound = stable_dc_bound(error_decay)
    if d <= bound * c_actual:
        return None
    suggest = -(-(int(d / bound) + 1) * 21 // 20)
    decay_note = "" if error_decay < 0.95 else (
        " or lower error_decay (gamma=0.9 moves the fitted cliff to d/c "
        f"~{predicted_dc_max(0.9):.0f})")
    rung = f" (ladder {label})" if label else ""
    return (
        f"sketch mode{rung} at realized d/c = {d / c_actual:.1f} (c_actual="
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
    arrays = {k: v if torch.is_tensor(v) else np.asarray(v)
              for k, v in batch.items()}
    return {k: a.reshape((a.shape[0], L, a.shape[1] // L)
                         + tuple(a.shape[2:]))
            for k, a in arrays.items()}


class _Rung:
    """One compression-ladder rung's resolved runtime: its Config, its
    CountSketch spec and compressor, the decode and aggregation resolved
    for the group, and its round closure. A session without the control
    plane is exactly one rung over the base config (label ""), built as
    the session always built itself."""

    __slots__ = ("cfg", "label", "spec", "compressor", "plan", "round_fn",
                 "sketch_decode_resolved", "aggregate_resolved")

    def __init__(self, cfg, label, spec, compressor, plan, round_fn,
                 sketch_decode_resolved, aggregate_resolved):
        self.cfg = cfg
        self.label = label  # "" (one rung) | "rung0", "rung1", ...
        self.spec = spec
        self.compressor = compressor
        self.plan = plan
        self.round_fn = round_fn
        self.sketch_decode_resolved = sketch_decode_resolved
        self.aggregate_resolved = aggregate_resolved  # "sparse" | "dense"


class FederatedSession:
    """Owns the worker group, the device, the CountSketch spec, the
    compressor, the round and the ``FedState``. ``params`` is a nested dict
    of arrays/tensors keyed like the reference's flax params
    (``ravel_pytree`` order). With ``num_devices > 1`` the session is one
    rank of the group (``parallel/mesh.py``) on ``cuda:LOCAL_RANK``; every
    rank holds the same state, but for the sharded leaves
    (``sharded_leaves``: true_topk's momentum and error under sparse
    aggregation, and under ``fsdp`` the params and every dense server
    leaf), of which each rank holds its ``[padded_dim(D, W) / W]`` slice;
    ``full_state`` gathers them and ``set_full_state`` slices them again
    (checkpoints and the interop with the reference carry the full
    layout). ``mask_batch(batch, row_mask)`` masks an eval batch's padded
    rows (``mask_classification``, or ``mask_gpt2`` for the GPT-2
    batch).

    ``rungs`` holds one ``_Rung`` per rung of the control plane's
    compression ladder (one rung over ``cfg`` without it), each with its
    own spec, compressor and round; ``spec``, ``compressor``, ``plan``
    and ``round_fn`` are the ACTIVE rung's (``active_rung``), and the
    state is in its layout. The controller (``controller``, attached by
    ``control.build_controller``) decides each round's rung in ``_round``
    before the dispatch, switching through ``set_active_rung``.

    With a hosted client store the banks are the streamer's
    (``clientstore.CohortStreamer``), not ``FedState`` leaves: ``host_vel``
    and ``host_err`` read them whole after the streamer's fence and load
    them (a restore, a rollback), ``stage_cohort_rows`` gathers a cohort's
    rows ahead, and ``close_client_store`` ends the streamer. In a worker
    group every rank's streamer holds the whole bank, gathers its own
    clients' rows and writes back the whole cohort's, so the banks stay
    identical, as the device banks do."""

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
        self._loss_fn = loss_fn
        self._padded = padded_dim(self.grad_size, self.group.size)
        self._gathered = None  # (the params slice, the gathered [D])
        # the control plane's controller (control/), attached by
        # build_controller once the train loop knows the run length; None
        # keeps every round on the path it ran before
        self.controller = None
        # the compression ladder's rungs: without the control plane ONE
        # rung over cfg itself (label ""), which builds exactly the
        # session it built before. With it, every rung's spec, compressor,
        # resolutions and round closure are built here, so a switch is a
        # lookup and the state's migration, never a build
        if cfg.control_enabled:
            from commefficient_tpu_torch.control import (
                initial_rung_index,
                ladder_configs,
                validate_rung_costs,
            )

            self.rungs = [self._build_rung(rc, f"rung{i}")
                          for i, rc in enumerate(ladder_configs(cfg))]
            if len(self.rungs) > 1:
                validate_rung_costs([self.rung_bytes_per_round(i)
                                     for i in range(len(self.rungs))])
            self.active_rung = initial_rung_index(cfg, len(self.rungs))
        else:
            self.rungs = [self._build_rung(cfg, "")]
            self.active_rung = 0
        rung = self.rungs[self.active_rung]
        self._use_rung(rung)
        # the state in the INITIAL rung's layout (under ef_feedback the
        # cheapest rung's)
        if cfg.fsdp:
            from commefficient_tpu_torch.parallel.fsdp import init_fsdp_state

            self.state = init_fsdp_state(rung.cfg, rung.compressor,
                                         vec.to(self.device), self.group)
        else:
            self.state = init_state(rung.cfg, rung.compressor,
                                    vec.to(self.device))
            if self.sparse_state:  # this rank's slice, zeros as well
                S = self._padded // self.group.size
                for leaf in self.sharded_leaves:
                    setattr(self.state, leaf, torch.zeros(
                        S, dtype=torch.float32, device=self.device))
        # the fedsim environment (None unless cfg.fedsim_enabled): round
        # state.step's masks, a pure function of (seed, step), so a
        # restored step realizes what the unbroken run realized
        self.fedsim_env = build_environment(cfg)
        # resilience/: the rounds below the replay horizon have run in this
        # process; a rollback rewinds the state, never the horizon, so a
        # re-executed round realizes its environment with replay=True (the
        # nan_client injection fires on a first execution only). A fresh
        # process, a resumed one too, starts at 0
        self._replay_horizon = 0
        # resilience/'s skip_clients blacklist: sorted unique client ids
        # masked out of every later round's live mask (None until
        # blacklist_clients), and the rider (build_resilience) whose
        # resilience/* scalars ride each round's metrics
        self._client_blacklist: Optional[np.ndarray] = None
        self.resilience = None
        self.eval_fn = build_eval_fn(loss_fn, unravel, mask_batch)
        # the training set on the device (attach_data), else None; which
        # data path the rounds take is ``data_path``
        self.dev_data: Optional[Dict[str, torch.Tensor]] = None
        self.dev_augment = None
        self._staging = threading.local()  # a RoundStager per thread
        self._stagers = []  # every thread's, for their pinned bytes
        # the device with its index: another thread starts on device 0
        self._cuda_device = (torch.device("cuda", torch.cuda.current_device())
                             if self.device.type == "cuda"
                             and self.device.index is None else self.device)
        # clientstore/'s streamer: None unless the store is hosted and the
        # mode keeps a client bank (build_streamer's gate); it stages
        # through the calling thread's RoundStager
        self._streamer = None
        if not cfg.fsdp:
            self._streamer = build_streamer(
                cfg, self.grad_size, needs_vel=cfg.local_momentum > 0,
                needs_err=cfg.error_type == "local",
                stager_fn=self._stager, device=self._cuda_device,
                rank=self.group.rank, group_size=self.group.size)
        # host observability, attached by a train loop at level >= 1
        # (telemetry.build_perf_observability): the span recorder, the
        # audit of the first dispatched round, and that audit once made
        self.spans = None
        self.audit_arm = None
        self.last_audit = None
        # asyncfed/'s (launch_fn, apply_fn) a rung, built on first use
        # (async_round_fns) or by prewarm_rungs
        self._async_fns: Dict[int, tuple] = {}

    # -- clientstore/'s banks (the checkpoint's and the vault's access) ------
    @property
    def host_vel(self):
        """The whole ``[num_clients, D]`` hosted velocity bank after the
        streamer's fence (every dispatched round's rows landed; a live
        view, which a caller that keeps it copies), or None without
        one. Assigning loads the bank and makes every staged or cached row
        stale (a restore, a rollback)."""
        if self._streamer is None or not self._streamer.has_vel:
            return None
        self._streamer.flush()
        return self._streamer.vel_array()

    @host_vel.setter
    def host_vel(self, arr):
        if self._streamer is None:
            raise ValueError(
                "cannot load host_vel: this session has no hosted client "
                "store (--client_store device, or no client-state mode)")
        self._streamer.load_vel(arr)

    @property
    def host_err(self):
        """``host_vel``'s twin for the local error bank."""
        if self._streamer is None or not self._streamer.has_err:
            return None
        self._streamer.flush()
        return self._streamer.err_array()

    @host_err.setter
    def host_err(self, arr):
        if self._streamer is None:
            raise ValueError(
                "cannot load host_err: this session has no hosted client "
                "store (--client_store device, or no client-state mode)")
        self._streamer.load_err(arr)

    def close_client_store(self) -> None:
        """Drain and release the streamer (writeback worker joined, an
        anonymous mmap file unlinked). Idempotent; nothing without a
        hosted store. The runner calls it on every exit."""
        if self._streamer is not None:
            self._streamer.close()

    @property
    def client_store_stats(self) -> Dict[str, int]:
        """The hosted store's counters: the stale cohorts gathered again,
        and the pinned host bytes its rows hold (the stagers' rings and
        the writeback's buffers); empty without a hosted store."""
        st = self._streamer
        if st is None:
            return {}
        return {"regathers": st.regathers,
                "pinned_bytes": st.pinned_bytes() + sum(
                    s.pinned_bytes("\0clientstore_") for s in self._stagers)}

    @property
    def spans(self):
        """The attached span recorder (None below level 1). Attaching it
        also reaches the streamer, whose writeback records on its own
        lane."""
        return self._spans

    @spans.setter
    def spans(self, value) -> None:
        self._spans = value
        if self._streamer is not None:
            self._streamer.spans = value

    # -- the compression ladder's rungs (control/) ----------------------------
    def _build_rung(self, rcfg, label: str) -> _Rung:
        """Resolve one rung: its CountSketch spec (and the envelope
        warning, a ``num_cols`` property, per rung), compressor, decode and
        aggregation resolutions and round closure. The degenerate-group
        warnings are given once a session, by the first rung built."""
        first = label in ("", "rung0")
        spec = None
        if compressor_class(rcfg.mode).needs_sketch_spec:
            spec = CountSketch(
                d=self.grad_size, c=rcfg.num_cols, r=rcfg.num_rows,
                num_blocks=rcfg.num_blocks, seed=rcfg.seed, m=rcfg.sketch_m,
                band=rcfg.sketch_band, hash_family=rcfg.hash_family,
                dtype=_DTYPES[rcfg.sketch_dtype],
                table_dtype=_DTYPES[rcfg.sketch_table_dtype])
            msg = envelope_warning(self.grad_size, spec.c_actual,
                                   rcfg.error_decay, label)
            if msg:
                warnings.warn(msg, stacklevel=4)
        compressor = get_compressor(rcfg, d=self.grad_size, spec=spec)
        W = self.group.size
        # which server decode and which aggregation the round runs (the
        # round builder makes the same calls); under FSDP, whose round
        # reduce-scatters anyway, both resolve dense (Config refuses an
        # explicit 'sparse' there, and auto picks it for no FSDP mode)
        plan = resolve_aggregation(rcfg, compressor, W)
        decode = ("sharded" if not rcfg.fsdp
                  and compressor.use_sharded_decode(W) else "dense")
        aggregate = "sparse" if plan.use_sparse_agg else "dense"
        if (first and rcfg.aggregate == "sparse" and not rcfg.fsdp
                and W == 1):
            warnings.warn(
                "aggregate='sparse' on a 1-device worker group is the "
                "degenerate case: there is no exchange to shrink, so the "
                "pair compaction and scatter are pure overhead on top of a "
                "sum over one device. 'auto' picks dense here for exactly "
                "that reason.", stacklevel=4)
        if (first and rcfg.sketch_decode == "sharded" and not rcfg.fsdp
                and W == 1):
            warnings.warn(
                "sketch_decode='sharded' on a 1-device worker group is the "
                "degenerate case: the one 'shard' decodes the FULL "
                "coordinate range through estimate_at, and the candidate "
                "exchange has no one to exchange with. The sharded decode "
                "only pays when the worker group is real; 'auto' picks "
                "dense here for exactly that reason.", stacklevel=4)
        if rcfg.fsdp:
            from commefficient_tpu_torch.parallel.fsdp import (
                build_fsdp_round_fn,
                validate_fsdp,
            )

            validate_fsdp(rcfg, compressor)
            round_fn = build_fsdp_round_fn(rcfg, self._loss_fn, self.unravel,
                                           compressor, self.group)
        else:
            round_fn = build_round_fn(rcfg, self._loss_fn, self.unravel,
                                      compressor, self.group)
        return _Rung(rcfg, label, spec, compressor, plan, round_fn, decode,
                     aggregate)

    def _use_rung(self, rung: _Rung) -> None:
        """Point the session's dispatch and accounting at ``rung``."""
        self.spec = rung.spec
        self.compressor = rung.compressor
        self.plan = rung.plan
        self.round_fn = rung.round_fn
        self.sketch_decode_resolved = rung.sketch_decode_resolved
        self.aggregate_resolved = rung.aggregate_resolved

    def set_active_rung(self, i: int, *, migrate: bool = True) -> None:
        """Switch the dispatch to rung ``i``: the session's spec,
        compressor and round closure become the rung's (a lookup: they
        were built with the session), and with ``migrate`` the
        compressor's ``FedState`` leaves are carried across by
        ``Compressor.migrate_state`` (a ``num_cols`` switch runs K2 and K1
        on the card). ``migrate=False`` is the checkpoint restore's: the
        restored leaves are ALREADY in rung ``i``'s layout."""
        i = int(i)
        if not 0 <= i < len(self.rungs):
            raise ValueError(f"rung {i} out of range (the ladder has "
                             f"{len(self.rungs)})")
        if i == self.active_rung:
            return
        old, new = self.rungs[self.active_rung], self.rungs[i]
        if migrate:
            st = self.state
            m, e, x = old.compressor.migrate_state(
                new.compressor, st.momentum, st.error, st.comp)
            m, e, x = self._commit_rung_leaves(new, m, e, x)
            self.state = FedState(**{**vars(st), "momentum": m, "error": e,
                                     "comp": x})
        self.active_rung = i
        self._use_rung(new)

    def _commit_rung_leaves(self, rung: _Rung, m, e, x):
        """Migrated leaves on this session's device in ``rung``'s layout:
        a leaf the migration passed through (the SAME tensor) is left
        alone; a whole ``[D]`` (or padded) vector arriving for a leaf
        ``rung`` shards is padded and cut to this rank's slice."""
        st = self.state
        sharded = self._sharded_leaves_of(rung)
        S = self._padded // self.group.size
        lo = self.group.rank * S

        def commit(name, leaf, old_leaf):
            if leaf is None or leaf is old_leaf:
                return leaf
            leaf = leaf.to(self.device)
            if (name in sharded and leaf.dim() == 1
                    and leaf.numel() in (self.grad_size, self._padded)):
                leaf = torch.nn.functional.pad(
                    leaf, (0, self._padded - leaf.numel()))[lo:lo + S].clone()
            return leaf

        return tuple(commit(n, leaf, o) for n, leaf, o in zip(
            ("momentum", "error", "comp"), (m, e, x),
            (st.momentum, st.error, st.comp)))

    def rung_state_template(self, i: int) -> Dict[str, Any]:
        """``{leaf: (shape, dtype) or None}`` of the compressor's leaves
        (``momentum``, ``error``, ``comp``) in ``full_state``'s layout at
        rung ``i``: what a checkpoint saved at that rung holds. Built on
        the ``meta`` device, so nothing is allocated."""
        rung = self.rungs[i]
        sharded = self._sharded_leaves_of(rung)
        out = {}
        for name, t in zip(("momentum", "error", "comp"),
                           rung.compressor.init_server_state("meta")):
            out[name] = None if t is None else (
                (self._padded,) if name in sharded else tuple(t.shape),
                t.dtype)
        return out

    def rung_bytes_per_round(self, i: int) -> Dict[str, int]:
        """Upload/download bytes per participating client at rung ``i``
        (the controller's and the per-rung ledger's source)."""
        rung = self.rungs[i]
        comp = rung.compressor
        up = comp.upload_floats()
        down = (2 * rung.cfg.k if rung.cfg.do_topk_down
                else comp.download_floats())
        return {"upload_floats": up, "download_floats": down,
                "upload_bytes": comp.upload_bytes_per_float() * up,
                "download_bytes": 4 * down}

    def prewarm_rungs(self) -> int:
        """On the card, build the host plans K1, K2 and K4 read for every
        rung's spec (the per-spec caches a first launch would fill; with
        the sharded decode, or FSDP's slice extraction, K4's range plan of
        this rank's slice as well) and, on a ladder, run each rung's
        migration ops once on scratch tensors
        (``Compressor.warm_migration``: torch loads a kernel at its first
        launch), so a switch to any rung builds and loads nothing; nothing
        to do on the CPU. Under asyncfed every rung's ``async_round_fns``
        pair is built too, so a switch or a retune builds nothing. Launches
        no CountSketch kernel and changes no state; returns the number of
        rungs."""
        if self.cfg.asyncfed_enabled:
            for i in range(len(self.rungs)):
                self.async_round_fns(i)
        if self.device.type == "cuda":
            from commefficient_tpu_torch.ops.cuda.countsketch import (
                prepare_plans,
            )

            for rung in self.rungs:
                if rung.spec is not None:
                    prepare_plans(rung.spec, self._cuda_device,
                                  slices=self.rung_range_slices(rung))
                if len(self.rungs) > 1:
                    rung.compressor.warm_migration(self._cuda_device)
        return len(self.rungs)

    def async_round_fns(self, rung: Optional[int] = None):
        """Rung ``rung``'s (the active one's by default) asyncfed
        ``(launch_fn, apply_fn)`` (``asyncfed/round.py``), built once and
        kept, so the engine and a switch back to the rung use the same
        pair."""
        i = self.active_rung if rung is None else int(rung)
        pair = self._async_fns.get(i)
        if pair is None:
            from commefficient_tpu_torch.asyncfed.round import (
                build_async_round_fns,
            )

            r = self.rungs[i]
            pair = build_async_round_fns(r.cfg, self._loss_fn, self.unravel,
                                         r.compressor, self.group)
            self._async_fns[i] = pair
        return pair

    def rung_range_slices(self, rung: _Rung):
        """The ``(start, n)`` slice of this rank that ``rung``'s server
        decode estimates through K4's range form each round: the sharded
        decode's and FSDP's extraction's (the compressor's
        ``shard_slice``); () otherwise (the slices ``estimate_all`` walks
        at ``num_blocks > 1`` are the spec's own: ``prepare_plans`` adds
        them)."""
        if rung.spec is None or not (rung.cfg.fsdp or
                                     rung.sketch_decode_resolved == "sharded"):
            return ()
        return (rung.compressor.shard_slice(self.group.rank, self.group.size,
                                            self.grad_size),)

    # -- the sharded leaves -------------------------------------------------
    @property
    def sparse_state(self) -> bool:
        """True when the server momentum and error live sharded over the
        group (true_topk's sparse aggregation)."""
        return self.plan.sparse_state

    @property
    def sharded_leaves(self) -> tuple:
        """The ``FedState`` leaves of which each rank holds its ``[S] =
        [padded_dim / W]`` slice: under ``fsdp`` the params and the dense
        server leaves, under true_topk's sparse aggregation its dense
        momentum and error; () otherwise."""
        return self._sharded_leaves_of(self.rungs[self.active_rung])

    @staticmethod
    def _sharded_leaves_of(rung: _Rung) -> tuple:
        if not (rung.cfg.fsdp or rung.plan.sparse_state):
            return ()
        kinds = rung.compressor.server_state_kinds()
        dense = tuple(leaf for leaf, kind in zip(("momentum", "error"),
                                                 kinds) if kind == KIND_DENSE)
        return ("params_vec",) + dense if rung.cfg.fsdp else dense

    def full_state(self) -> FedState:
        """The state with every sharded leaf gathered over the group into
        its padded ``[padded_dim]`` vector (every rank must call it: it is
        a collective); the other leaves as they are."""
        st = self.state
        full = {leaf: self.group.all_gather(getattr(st, leaf))
                for leaf in self.sharded_leaves}
        return FedState(**{**vars(st), **full})

    def set_full_state(self, state: FedState) -> None:
        """Install ``state`` (the layout ``full_state`` gives; a sharded
        leaf may also come as the unpadded ``[D]``): each sharded leaf
        padded to ``padded_dim`` and sliced to this rank's ``[S]``."""
        leaves = dict(vars(state))
        S = self._padded // self.group.size
        lo = self.group.rank * S
        for leaf in self.sharded_leaves:
            t = leaves[leaf].to(self.device, torch.float32)
            if t.numel() == self.grad_size:
                t = torch.nn.functional.pad(t, (0, self._padded - t.numel()))
            if t.shape != (self._padded,):
                raise ValueError(
                    f"{leaf} is {tuple(t.shape)}; a sharded leaf is the "
                    f"whole [{self._padded}] (or [{self.grad_size}]) vector")
            leaves[leaf] = t[lo:lo + S].clone()
        self.state = FedState(**leaves)

    def full_shape(self, leaf: str):
        """The shape of ``leaf`` in ``full_state``'s layout (None when
        absent)."""
        t = getattr(self.state, leaf)
        if t is None or not torch.is_tensor(t):
            return None
        return ((self._padded,) if leaf in self.sharded_leaves
                else tuple(t.shape))

    def full_params_vec(self) -> torch.Tensor:
        """The whole ``[D]`` params vector. Under ``fsdp`` it is gathered
        over the group (a collective: every rank calls it) and kept until
        the state's params change, so a rank that evaluates alone (the
        runner's rank 0) reads the gather every rank made just before."""
        pv = self.state.params_vec
        if not self.cfg.fsdp:
            return pv
        if self._gathered is None or self._gathered[0] is not pv:
            self._gathered = (pv, self.group.all_gather(pv)[:self.grad_size])
        return self._gathered[1]

    @property
    def data_path(self) -> str:
        """``"device"`` when the training set is attached and rounds run
        through ``train_round_indices``, else ``"host"``."""
        return "host" if self.dev_data is None else "device"

    def maybe_attach_data(self, dataset, sampler, augment=None) -> bool:
        """Attach ``dataset``'s arrays on the device iff ``device_data`` is
        on, the sampler can drive index-only rounds (``fusable``), every
        array is numpy and they total at most ``device_data_max_mb`` MB
        (1e6 bytes) — the reference's gate (FSDP rounds, a hosted client
        store and the asyncfed engine, whose launch takes the staged host
        batch, take the host batch). True when the index path is live."""
        if not (self.cfg.device_data and not self.cfg.fsdp
                and not self.cfg.client_state_hosted
                and not self.cfg.asyncfed_enabled
                and sampler.fusable
                and all(isinstance(v, np.ndarray)
                        for v in dataset.data.values())
                and sum(v.nbytes for v in dataset.data.values())
                <= self.cfg.device_data_max_mb * 1_000_000):
            return False
        self.attach_data(dataset.data, augment)
        return True

    def attach_data(self, data: Dict[str, np.ndarray], augment=None) -> None:
        """Put the whole training set on the device, each array in its own
        dtype (uint8 images stay uint8). ``augment`` is the sampler's
        plan-based augment or None; its ``device_apply`` realizes a plan
        on the device. Refused with a hosted client store (the reference's
        refusal)."""
        if self.cfg.client_state_hosted:
            raise NotImplementedError(
                "device-resident data + host-resident client state "
                "(--client_store host|mmap) is contradictory; pick one")
        self.dev_data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in data.items()}
        self.dev_augment = augment

    def local_clients(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's slice ``[p*w_loc, (p+1)*w_loc)`` of a round's
        ``[W, ...]`` batch (host arrays, or staged device tensors)."""
        w_loc = self.cfg.num_workers // self.group.size
        lo = self.group.rank * w_loc
        return {k: (v if torch.is_tensor(v) else np.asarray(v))[lo:lo + w_loc]
                for k, v in batch.items()}

    # -- early H2D copies (the pipelined engine's worker thread) ----------
    def _stager(self) -> Optional[RoundStager]:
        """This thread's ``RoundStager`` (its stream and pinned rings), made
        on first use; None on the CPU, where staging is the identity."""
        if self.device.type != "cuda":
            return None
        st = getattr(self._staging, "stager", None)
        if st is None:
            st = RoundStager(self._cuda_device, self.cfg.pipeline_depth + 1)
            self._staging.stager = st
            self._stagers.append(st)
        return st

    @property
    def staging_alloc(self):
        """The sampler's ``alloc`` for this thread (the next pinned buffer
        of the stager's ring), or None on the CPU."""
        st = self._stager()
        return None if st is None else st.host_buffer

    def _host_ids(self, client_ids) -> np.ndarray:
        host = np.asarray(client_ids, dtype=np.int64)
        if (host.shape != (self.cfg.num_workers,) or host.min() < 0
                or host.max() >= self.cfg.num_clients):
            raise ValueError(
                f"client_ids must be {self.cfg.num_workers} ids in "
                f"[0, {self.cfg.num_clients}), got {host.tolist()}")
        return host

    def stage_round_payload(self, client_ids, batch: Dict[str, Any]):
        """Start one round's H2D copy now, from the calling (staging)
        thread: ``(client_ids, batch, ready)`` for ``train_round(...,
        ready=ready)``. On the card the ids (checked here, on the host) and
        the ``[W, ...]`` arrays are copied from pinned memory on the
        thread's own stream and ``ready`` is the event after the copies;
        on the CPU this is the identity (``ready`` None)."""
        st = self._stager()
        if st is None:
            return client_ids, batch, None
        arrays = dict(batch)
        if client_ids is not None:
            arrays["\0ids"] = self._host_ids(client_ids)
        dev, ready = st.stage(arrays)
        ids = dev.pop("\0ids", None)
        return ids, dev, ready

    def stage_round_indices(self, client_ids, idx, plan):
        """``stage_round_payload`` for the index round: ``(client_ids, idx,
        plan, ready)`` for ``train_round_indices(..., ready=ready)``, the
        ``[W, B]`` indices and the plan's ``[W*B]`` arrays copied early
        (the identity on the CPU)."""
        st = self._stager()
        if st is None:
            return client_ids, idx, plan, None
        arrays = {"\0idx": idx, **{f"\0plan{i}": a
                                    for i, a in enumerate(plan)}}
        if client_ids is not None:
            arrays["\0ids"] = self._host_ids(client_ids)
        dev, ready = st.stage(arrays)
        return (dev.get("\0ids"), dev["\0idx"],
                tuple(dev[f"\0plan{i}"] for i in range(len(plan))), ready)

    def _local_ids(self, client_ids) -> np.ndarray:
        """This rank's ``w_loc`` of a round's ``[W]`` host client ids."""
        w_loc = self.cfg.num_workers // self.group.size
        lo = self.group.rank * w_loc
        return np.asarray(client_ids, np.int64).reshape(-1)[lo:lo + w_loc]

    def stage_cohort_rows(self, client_ids, trace_id=None):
        """Gather this rank's hosted rows of the cohort (``client_ids``,
        the round's ``[W]`` host ids) now, from the calling thread, and
        start their copy to the card on its stager's stream: the
        ``StagedCohort`` for ``train_round(..., cohort=)``, which uses it
        unless a row was written since (then it gathers again). None
        without a hosted store. ``trace_id`` names the round in the
        ``clientstore_gather`` span."""
        if self._streamer is None:
            return None
        return self._streamer.gather(self._local_ids(client_ids),
                                     trace_id=trace_id)

    def _cohort_rows(self, cids: np.ndarray, cohort, trace_id):
        """This rank's ``(vel_rows, err_rows)`` of the round's cohort
        (``cids``, the ``[W]`` host ids), on the device and ready for the
        compute stream: ``cohort`` as staged unless it is None or stale,
        else gathered now; the compute stream waits on its copy, then
        the cached rows are spliced in. An absent bank's rows are
        None."""
        st = self._streamer
        mine = self._local_ids(cids)
        if cohort is None or st.is_stale(mine, cohort.version):
            cohort = st.gather(mine, trace_id=trace_id)
        self._consume(cohort.ready, [cohort.vel, cohort.err])
        return tuple(t if torch.is_tensor(t) else None
                     for t in st.splice(cohort))

    # -- fedsim and resilience/ ----------------------------------------------
    def sync_round_clock(self) -> None:
        """Align the fedsim round clock with ``FedState.step`` after the
        state was replaced (a checkpoint restore, a rollback). The port's
        rounds realize their environment from ``state.step`` itself, so
        there is no separate clock to move: the reference's call is kept
        as a no-op."""

    def fedsim_round_env(self, step: int, client_ids=None, *,
                         replay: Optional[bool] = None):
        """Round ``step``'s ``RoundEnv`` as a round realizes it (None
        without fedsim): with ``replay`` (by default: ``step`` lies below
        the replay horizon, a round this process already ran) the
        nan_client injection is suppressed, and with the host
        ``client_ids`` the blacklist is composed in."""
        if self.fedsim_env is None:
            return None
        if replay is None:
            replay = step < self._replay_horizon
        env = self.fedsim_env.round_env(step, replay=replay)
        if client_ids is not None:
            env = self.blacklist_env(env, client_ids)
        return env

    def blacklist_clients(self, client_ids) -> np.ndarray:
        """Add ``client_ids`` to the blacklist (resilience/'s
        ``skip_clients``): a blacklisted client is masked out of every
        later round's live mask by the same ``torch.where`` the fedsim mask
        rides, before ``device_encode``, and the server renormalizes by
        the reduced live count. Returns the whole blacklist. Needs a
        fedsim session: without one the round masks nothing and the
        blacklist would be silently inert."""
        if self.fedsim_env is None:
            raise ValueError(
                "blacklist_clients needs a fedsim session (the round must "
                "mask clients — cfg.fedsim_enabled); this session was "
                "built without it")
        ids = np.unique(np.asarray(client_ids, np.int64))
        if self._client_blacklist is not None:
            ids = np.union1d(self._client_blacklist, ids)
        self._client_blacklist = ids
        return ids

    def blacklist_env(self, env, client_ids):
        """``env`` with the blacklist composed in for the host
        ``client_ids`` (``_blacklist_env``); ``env`` itself without a
        blacklist or an env."""
        if env is None or self._client_blacklist is None:
            return env
        return self._blacklist_env(env, client_ids)

    def control_round_start(self, step: int, fs_stats=None) -> None:
        """The control plane's decision point for round ``step``, on the
        host before its dispatch (nothing without a controller): the
        asyncfed engine calls it once an update, with the update's
        ``fedsim/*`` and ``async/*`` scalars, as ``_round`` calls it with
        the environment's."""
        if self.controller is not None:
            self.controller.on_round_start(step, fs_stats)

    def mark_dispatched(self, step: int) -> None:
        """Round ``step`` has run in this process: the replay horizon moves
        past it (a rollback's replay realizes it with ``replay=True``)."""
        self._replay_horizon = max(self._replay_horizon, int(step) + 1)

    def _blacklist_env(self, env, client_ids):
        """``env`` with the blacklist composed in, on the host: a
        blacklisted LIVE slot drops out (dropped: the server neither takes
        its upload nor sends it the download), and the live count and the
        ``fedsim/*`` scalars the ledger bills from follow the reduced
        mask. A slot already out stays as it was."""
        bl = np.isin(np.asarray(client_ids, np.int64),
                     self._client_blacklist)
        hit = bl & (env.live > 0)
        n_hit = int(hit.sum())
        if n_hit == 0:
            return env
        live = env.live.copy()
        live[hit] = 0.0
        n_live = float(live.sum())
        stats = dict(env.stats)
        stats["fedsim/participation_rate"] = n_live / live.shape[0]
        stats["fedsim/dropped"] = float(stats.get("fedsim/dropped", 0.0)
                                        + n_hit)
        stats["fedsim/all_dropped"] = float(n_live == 0)
        return env._replace(live=live.astype(np.float32),
                            live_count=np.float32(n_live), stats=stats)

    def _consume(self, ready, tensors) -> None:
        """Before a staged round's first use: the compute stream waits on
        the staging event, and each staged tensor is recorded on it."""
        if ready is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ready)
        for t in tensors:
            if torch.is_tensor(t):
                t.record_stream(cur)

    def train_round(self, client_ids, batch: Dict[str, Any], lr: float,
                    env=None, ready=None, cohort=None, host_ids=None):
        """One round on ``batch`` ({k: [W, B, ...]} host arrays, for fedavg
        ``[W, L, B, ...]`` (``microbatched``); the same on every rank, and
        each rank computes its own clients). ``client_ids`` ([W] ints) name
        the participants; modes with client state (local momentum, local
        error feedback) need them and raise without, the others may pass
        ``None``. Returns the round's metrics as 0-d device tensors
        (``loss`` = mean client loss over all W, over the live clients
        under fedsim), the ``diag/*`` 0-d device tensors at
        ``cfg.telemetry_level >= 1`` (``telemetry/diagnostics.py``), plus
        the ``fedsim/*`` host scalars under fedsim (the same keys every
        round of a run).

        ``env`` (a ``fedsim.RoundEnv``) overrides the session
        environment's draw for this round (tests drive explicit masks
        through it); by default a fedsim session realizes round
        ``state.step``'s environment. An ``env`` for a session built
        without fedsim raises.

        A staged round (``stage_round_payload``) passes its device tensors
        and ``ready``: they go through as they are, after the compute
        stream waits on ``ready``.

        With a hosted client store the round needs the cohort's HOST ids:
        ``client_ids`` as given, or ``host_ids`` when ``client_ids`` were
        staged on the card. ``cohort`` is the ``StagedCohort`` of
        ``stage_cohort_rows`` (the prefetcher's); it is used unless None or
        stale, else the rows are gathered at the dispatch. The round's new
        rows go back through the streamer (``scatter``: asynchronous, its
        fence is ``host_vel``/``host_err`` or ``close_client_store``), and
        at level >= 1 its metrics carry the ``clientstore/*`` scalars.

        With a span recorder attached (``spans``), the round records
        ``device_put`` (the copy of its inputs), ``fedsim_env`` and
        ``round_dispatch`` under its trace id, and its metrics gain the
        host scalars ``xla/exposed_collective_ms`` and the lagged
        ``trace/*`` of round ``step - 2``."""
        blacklist_ids = self._host_client_ids(client_ids)
        cohort_ids = None
        if self._streamer is not None:
            cohort_ids = (blacklist_ids if host_ids is None
                          else np.asarray(host_ids))
            if cohort_ids is None:
                raise ValueError(
                    "a hosted client store needs the round's host client "
                    "ids: pass host_ids= with ids staged on the card")
        with self._span("device_put", trace_id=round_trace_id(
                self.state.step)):
            ids, dev_batch = self.device_inputs(client_ids, batch, ready)
        return self._round(ids, dev_batch, lr, env, blacklist_ids,
                           cohort_ids, cohort)

    def device_inputs(self, client_ids, batch: Dict[str, Any], ready=None):
        """``(device client ids, this rank's device batch)`` of a round's
        ``[W]`` ids and ``[W, ...]`` host (or staged) batch, after the
        compute stream waits on a staged copy's ``ready``."""
        self._consume(ready, [client_ids, *batch.values()])
        return (self._device_ids(client_ids),
                _to_device(self.local_clients(batch), self.device))

    def train_round_indices(self, client_ids, idx, plan, lr: float,
                            env=None, ready=None):
        """One round from the attached training set (``attach_data``):
        ``idx`` ``[W, B]`` sample indices and ``plan`` the augment plan's
        ``[W*B]`` arrays (``()`` without an augment), as
        ``FedSampler.sample_round_indices`` gives them. This rank's
        clients' rows are gathered on the device in one flat gather, the
        augment's ``device_apply`` runs on them, and the batch, shaped
        ``[w, B, ...]`` (fedavg: ``[w, L, B/L, ...]``), goes through the
        round ``train_round`` runs. Returns what ``train_round`` does.
        Staged ``idx`` and ``plan`` (``stage_round_indices``) go through as
        they are, after the compute stream waits on ``ready``. The gather
        and augment are the round's ``device_put`` span."""
        if self.dev_data is None:
            raise ValueError("train_round_indices needs the training set "
                             "on the device: call attach_data first")
        host_ids = self._host_client_ids(client_ids)
        with self._span("device_put", trace_id=round_trace_id(
                self.state.step)):
            self._consume(ready, [client_ids, idx, *plan])
            ids = self._device_ids(client_ids)
            w_loc = self.cfg.num_workers // self.group.size
            lo = self.group.rank * w_loc
            idx = _as_device(idx, self.device)[lo:lo + w_loc]
            B = idx.shape[1]
            flat = idx.reshape(-1).to(torch.int64)
            batch = {}
            for k, v in self.dev_data.items():
                g = v[flat]
                if k == "x" and self.dev_augment is not None:
                    g = self.dev_augment.device_apply(g, *(
                        _as_device(a, self.device)[lo * B:(lo + w_loc) * B]
                        for a in plan))
                batch[k] = g.reshape((w_loc, B) + tuple(g.shape[1:]))
        return self._round(ids, microbatched(self.cfg, batch), lr, env,
                           host_ids)

    @staticmethod
    def _host_client_ids(client_ids):
        """The round's client ids as the host holds them, for the
        blacklist; None for staged ids on the card (the prefetcher
        composed the blacklist into their round's environment)."""
        if client_ids is None or (torch.is_tensor(client_ids)
                                  and client_ids.is_cuda):
            return None
        return np.asarray(client_ids)

    def _device_ids(self, client_ids):
        """The round's ``[W]`` client ids on the device (None without)."""
        if torch.is_tensor(client_ids) and client_ids.is_cuda:
            return client_ids  # staged: checked on the host when staged
        if client_ids is not None:
            return torch.from_numpy(self._host_ids(client_ids)).to(
                self.device)
        return None

    def _span(self, name: str, fence=None, collective: bool = False,
              trace_id=None):
        """A phase span of the attached recorder (``telemetry/spans.py``),
        or a context that records nothing without one. ``collective=True``
        tags a dispatch whose fence waits on the group's collectives."""
        if self.spans is None:
            return contextlib.nullcontext()
        return self.spans.span(name, fence=fence, collective=collective,
                               trace_id=trace_id)

    def _round(self, ids, batch: Dict[str, torch.Tensor], lr: float, env,
               host_ids=None, cohort_ids=None, cohort=None):
        """The round of ``train_round`` and ``train_round_indices`` on this
        rank's device batch and device ids; ``host_ids`` (the host's
        client ids, or None) compose the blacklist into the environment
        before anything of it goes to the card. With a hosted store,
        ``cohort_ids`` are the round's ``[W]`` host ids and ``cohort`` the
        staged rows (``_cohort_rows``); the new rows are scattered back
        right after the dispatch."""
        step = self.state.step
        tid = round_trace_id(step)
        with self._span("fedsim_env", trace_id=tid):
            if env is None and self.fedsim_env is not None:
                env = self.fedsim_round_env(step)
            elif env is not None and self.fedsim_env is None:
                raise ValueError(
                    "env= passed but this session was built without "
                    "fedsim (cfg.fedsim_enabled is False, so the round "
                    "masks nothing); construct the Config with "
                    "availability/chaos set to drive masked rounds")
            if host_ids is not None:
                env = self.blacklist_env(env, host_ids)
        # the control plane's decision point, on the host before the
        # dispatch: it may switch the rung (and migrate the state) or raise
        # BudgetExhaustedError, so the round never runs
        self.control_round_start(step,
                                 env.stats if env is not None else None)
        lr = float(np.float32(lr))  # the reference's f32 lr
        rows = ()
        if self._streamer is not None:
            # the cohort's rows are arguments of the round: no bank of
            # [num_clients, D] is read on the card
            rows = self._cohort_rows(cohort_ids, cohort, tid)
        arm = self.audit_arm if self.audit_arm is not None \
            and self.audit_arm.armed else None
        # the dispatch waits on the group's collectives; one device has
        # none, and a tagged span would charge its compute to the
        # critical path's "collective" stage
        with self._span("round_dispatch", collective=self.group.size > 1,
                        trace_id=tid) as sp:
            with arm.measure(step) if arm else contextlib.nullcontext():
                out = self.round_fn(self.state, ids, batch, lr, *rows,
                                    env=env)
            self.state, metrics = out[:2]
            if rows:
                # asynchronous: the writeback waits on an event recorded
                # on this stream now, after the round's kernels
                self._streamer.scatter(cohort_ids, *out[2:], trace_id=tid)
            if sp is not None:
                sp.fence(metrics["loss"])
        self.mark_dispatched(step)
        if arm:
            arm.finish()  # the report, outside the round's spans
        return self.host_round_stats(
            metrics, env.stats if env is not None else None)

    def host_round_stats(self, metrics: dict, fs_stats=None) -> dict:
        """A dispatched round's metrics with the host scalars added, the
        same keys every round: ``fs_stats`` (the environment's
        ``fedsim/*``; under asyncfed also the update's ``async/*``), the
        controller's ``control/*``, the resilience rider's, a hosted
        store's ``clientstore/*`` and, with spans at level >= 1,
        ``xla/exposed_collective_ms`` and the lagged ``trace/*``."""
        if fs_stats:
            metrics = {**metrics, **fs_stats}
        if self.controller is not None:
            metrics = {**metrics, **self.controller.scalars()}
        if self.resilience is not None:
            metrics = {**metrics, **self.resilience.scalars()}
        if self._streamer is not None and self.cfg.telemetry_level >= 1:
            # the same four keys every round: cache hit rate, evictions,
            # stage and writeback ms since the last round
            metrics = {**metrics, **self._streamer.pop_round_stats()}
        if self.spans is not None and self.cfg.telemetry_level >= 1:
            # host scalars, the same keys every round: the exposure (0.0
            # when the audited round held no collective) and the trace/*
            # of round step - 2, the newest whose spans are complete now
            # (round step - 1's drain has not run)
            metrics = {**metrics, "xla/exposed_collective_ms":
                       exposed_collective_ms(self.spans, self.last_audit),
                       **trace_round_scalars(self.spans, self.state.step - 2)}
        return metrics

    def audit_bounds(self) -> Dict[str, Any]:
        """The ledger and collective bounds the round audit checks its
        counts against (the reference's ``_audit_bounds``): ``wk_bound`` on
        the sharded sketch decode, ``sparse_agg_bound`` (and the
        device-resident client rows' exemption) under sparse aggregation,
        the ``overlap`` block under layerwise overlap."""
        cfg = self.rungs[self.active_rung].cfg
        W = self.group.size
        is_sketch = not cfg.fsdp and self.compressor.supports_sharded_decode
        sharded = is_sketch and self.sketch_decode_resolved == "sharded"
        up = self.bytes_per_round()["upload_bytes"]
        has_sparse_agg = (not cfg.fsdp
                          and self.compressor.supports_sparse_aggregate)
        aggregate = self.aggregate_resolved if has_sparse_agg else None
        sparse_agg_bound = None
        sparse_agg_exemption = None
        if aggregate == "sparse":
            # the largest legal all-reduce / all-gather: the pair exchange
            # (sketch keeps its table all-reduce, its design payload)
            sparse_agg_bound = W * cfg.k
            if self.compressor.needs_sketch_spec:
                r, c = self.spec.table_shape
                sparse_agg_bound = max(sparse_agg_bound, int(r) * int(c))
            elif not self.compressor.sparse_aggregate_shards_state:
                w_loc = max(1, cfg.num_workers // W)
                sparse_agg_bound = W * w_loc * cfg.k
            if ((cfg.local_momentum > 0 or cfg.error_type == "local")
                    and not (cfg.client_state_hosted and W == 1)):
                # the client rows' write-back gathers the round's w rows
                # of D: state residency, not aggregation. A hosted store
                # at one rank gathers nothing (the rows are the round's
                # arguments and results); in a group each rank's bank
                # still needs every rank's rows
                sparse_agg_bound = max(sparse_agg_bound,
                                       cfg.num_workers * self.grad_size)
                sparse_agg_exemption = "client_state_writeback"
        overlap_info = None
        if cfg.overlap_collectives != "none" or cfg.async_double_buffer:
            overlap_info = {"collectives": cfg.overlap_collectives,
                            "double_buffer": bool(cfg.async_double_buffer)}
        return dict(
            mode=cfg.mode,
            sketch_decode=self.sketch_decode_resolved if is_sketch else None,
            aggregate=aggregate,
            grad_size=self.grad_size,
            workers_mesh=W,
            ledger_up_bytes=up,
            wk_bound=W * cfg.k if sharded else None,
            sparse_agg_bound=sparse_agg_bound,
            sparse_agg_exemption=sparse_agg_exemption,
            tolerance_bytes=ledger_tolerance(up, sharded=sharded, workers=W,
                                             k=cfg.k),
            overlap_info=overlap_info,
        )

    def evaluate(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, float]:
        """Metrics over eval batches (padded rows masked): ``loss`` (the
        mean over valid rows), ``accuracy`` (``correct / count``), the raw
        totals of every other sum-style key (``*_sum``, ``*_count``: the
        GPT-2 token-weighted ``lm_loss_sum`` / ``token_count``), and the
        row-weighted mean of any other key (the reference's rule)."""
        totals: Dict[str, float] = {}
        n = 0.0
        pv = self.full_params_vec()
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
        return self.unravel(self.full_params_vec())

    def bytes_per_round(self) -> Dict[str, int]:
        """Upload/download bytes per participating client at the active
        rung."""
        return self.rung_bytes_per_round(self.active_rung)


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

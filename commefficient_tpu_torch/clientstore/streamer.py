"""CohortStreamer: the host bank to the cohort's device rows and back, off
the round's critical path (the port's copy of
``commefficient_tpu/clientstore/streamer.py``).

One streamer per hosted session owns the velocity and error stores
(``store.py``), the optional LRU cache of device rows (``cache.py``) and
the writeback worker. Its contract with the round:

  * ``gather(cids) -> StagedCohort``: the cohort's ``[n, D]`` rows a bank
    (``()`` for an absent bank), read cache-first and then from the bank
    into a host buffer the session's ``stager`` hands out (on the card a
    pinned slot of the calling thread's ``RoundStager`` ring) and copied
    to the device on that stager's stream; ``ready`` is the event after
    the copy. Cached rows are device rows: they are spliced into the
    staged block by ``splice``, on the stream that consumes it, after
    that stream has waited on ``ready``. The pipeline's prefetch thread
    calls ``gather`` for round t+1 while round t runs;
  * ``scatter(cids, new_vel, new_err)``: the round's updated rows. With the
    cache, they go into it dirty (written through on eviction). Without
    it, the writeback worker copies them to the host and into the bank
    ASYNCHRONOUSLY: on the card an event recorded on the compute stream
    after the dispatch, which the worker's own stream waits on before its
    copy into pinned memory, so the copy never reads rows the round has
    not written, and never queues behind the next round's kernels;
  * versions: every scatter bumps a version and stamps ``last_write`` at
    its ids; a ``StagedCohort`` holds its gather's version, and
    ``is_stale`` tells the dispatch that a staged row was overwritten
    since (the same client drawn twice inside the pipeline window): the
    round then gathers again, synchronously, so a pipelined run is
    bit-equal to the synchronous one;
  * ``flush()``: the fence. It joins the pending writebacks and writes the
    dirty cached rows through, so a checkpoint, a vault snapshot or a
    whole-bank read sees every completed round.

A writeback fault is kept and raised again at the next ``gather`` or
``flush`` (a ``RuntimeError``): the run fails, and nothing falls back.
``pop_round_stats`` drains the four ``clientstore/*`` scalars (hit rate,
evictions, stage ms, writeback ms) under a constant key set.

With a span recorder (``spans``, set by the session's ``spans`` setter at
telemetry level >= 1) the streamer records ``clientstore_gather`` on the
calling thread, ``clientstore_writeback`` on the worker's own lane and
``clientstore_flush`` on the fencing thread, the first two stamped with
the owning round's trace id (the caller passes it: the streamer keeps no
round clock).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from commefficient_tpu_torch.clientstore.cache import LRURowCache
from commefficient_tpu_torch.clientstore.store import build_store
from commefficient_tpu_torch.telemetry.trace import step_of_trace_id

_END = object()
BANKS = ("vel", "err")


class StagedCohort(NamedTuple):
    """A gathered cohort: each bank's staged device rows (or ``()``), the
    gather's version, the staging event (None off the card) and the
    cached rows still to splice in, ``((position, (vel_row, err_row)),
    ...)``."""

    vel: Any
    err: Any
    version: int
    ready: Any = None
    hot: tuple = ()


class HostStager:
    """The stager of a CPU session and of the tests: plain numpy buffers,
    and 'staging' is ``torch.from_numpy`` (no copy, no event)."""

    @staticmethod
    def host_buffer(key: str, shape, dtype) -> np.ndarray:
        return np.empty(shape, dtype)

    @staticmethod
    def stage(arrays: dict):
        return {k: torch.from_numpy(np.asarray(a)) for k, a in
                arrays.items()}, None


class _WriteEntry:
    __slots__ = ("ids", "idset", "rows", "event", "done", "trace_id")

    def __init__(self, ids, rows, event, trace_id=None):
        self.ids = ids
        self.idset = set(int(i) for i in ids)
        self.rows = rows  # {bank: [n, D] tensor}
        self.event = event  # the compute stream's event after the round
        self.done = threading.Event()
        # the owning round's trace id: the worker's span names it
        self.trace_id = trace_id


class CohortStreamer:
    """``stager_fn()`` returns the calling thread's stager (``host_buffer``
    and ``stage``, as ``parallel.api.RoundStager``), or None to stage with
    ``HostStager`` (so does a streamer without one). ``device`` is the
    rows' device: on a CUDA device the writeback runs on the worker's own
    stream."""

    def __init__(self, *, vel_store=None, err_store=None, num_clients: int,
                 cache_rows: int = 0, stager_fn=None, device="cpu"):
        if vel_store is None and err_store is None:
            raise ValueError("streamer needs at least one bank")
        self.stores = {"vel": vel_store, "err": err_store}
        self.vel_store, self.err_store = vel_store, err_store
        self.num_clients = int(num_clients)
        self._stager_fn = stager_fn or (lambda: None)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._version = 0
        self._last_write = np.zeros(self.num_clients, np.int64)
        self._pending: list = []
        self._fault: Optional[BaseException] = None
        self._q: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._wb_stream = None  # the worker's CUDA stream
        self._wb_host: dict = {}  # bank -> the worker's pinned buffer
        self._closed = False
        self._cache = (LRURowCache(cache_rows, self._cache_writeback)
                       if cache_rows else None)
        # the per-round scalars' accumulators (pop_round_stats drains them)
        self._stage_ms = 0.0
        self._writeback_ms = 0.0
        self._hits0 = self._misses0 = self._evictions0 = 0
        self.regathers = 0  # staged cohorts found stale and gathered again
        self.spans = None
        self._worker_lane_named = False

    @property
    def has_vel(self) -> bool:
        return self.vel_store is not None

    @property
    def has_err(self) -> bool:
        return self.err_store is not None

    # -- writeback ------------------------------------------------------------
    def _cache_writeback(self, cid, pair) -> None:
        """Eviction or flush write-through of one cached row pair, under
        the streamer's lock; the copy to the host waits for the row."""
        t0 = time.perf_counter()
        for bank, row in zip(BANKS, pair):
            if row is not None:
                self.stores[bank].scatter_rows(
                    [cid], row.detach().cpu().numpy()[None])
        self._writeback_ms += (time.perf_counter() - t0) * 1e3

    def _ensure_worker(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._worker_loop, name="clientstore-writeback",
                daemon=True)
            self._worker.start()

    def _to_host(self, e: _WriteEntry, bank: str) -> np.ndarray:
        """Entry ``e``'s rows of ``bank`` as host numpy. On the card: the
        worker's stream waits on the round's event, copies into the
        worker's pinned buffer, and the worker waits for that copy."""
        rows = e.rows[bank]
        if e.event is None:
            return rows.detach().cpu().numpy()
        host = self._wb_host.get(bank)
        if host is None or tuple(host.shape) != tuple(rows.shape):
            host = torch.empty(tuple(rows.shape), dtype=rows.dtype,
                               pin_memory=True)
            self._wb_host[bank] = host
        with torch.cuda.stream(self._wb_stream):
            self._wb_stream.wait_event(e.event)
            host.copy_(rows, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._wb_stream)
        copied.synchronize()
        return host.numpy()

    def _worker_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # per thread
        while True:
            e = self._q.get()
            if e is _END:
                return
            try:
                t0 = time.perf_counter()
                for bank in e.rows:
                    self.stores[bank].scatter_rows(e.ids,
                                                   self._to_host(e, bank))
                t1 = time.perf_counter()
                with self._lock:
                    self._writeback_ms += (t1 - t0) * 1e3
                self._record_writeback_span(e, t0, t1)
            except BaseException as exc:  # noqa: BLE001 - raised at the consumer
                with self._lock:
                    self._fault = exc
            finally:
                e.rows = {}  # the device rows may go now
                with self._lock:
                    if e in self._pending:
                        self._pending.remove(e)
                e.done.set()

    def _record_writeback_span(self, e, t0: float, t1: float) -> None:
        spans = self.spans
        if spans is None:
            return
        if not self._worker_lane_named:
            spans.register_lane("clientstore-writeback")
            self._worker_lane_named = True
        spans.span_at("clientstore_writeback", t0, t1,
                      step=step_of_trace_id(e.trace_id), trace_id=e.trace_id)

    def _raise_fault(self) -> None:
        with self._lock:
            fault, self._fault = self._fault, None
        if fault is not None:
            raise RuntimeError(
                "clientstore writeback worker died; client state may be "
                "behind — failing the run") from fault

    # -- the cohort contract --------------------------------------------------
    def gather(self, cids, trace_id=None) -> StagedCohort:
        """Stage the cohort's rows: cached rows (to ``splice`` in) first,
        the rest from the bank, after any pending writeback of the same
        ids has landed. ``trace_id`` stamps the ``clientstore_gather``
        span with the owning round."""
        self._raise_fault()
        ids = np.asarray(cids, np.int64).reshape(-1)
        idset = set(int(i) for i in ids)
        with self._lock:
            version = self._version
            cached = {}
            if self._cache is not None:
                for pos, cid in enumerate(int(i) for i in ids):
                    pair = self._cache.get(cid)
                    if pair is not None:
                        cached[pos] = pair
            missing = [p for p in range(len(ids)) if p not in cached]
            waits = ([e for e in self._pending if e.idset & idset]
                     if missing else [])
        for e in waits:
            e.done.wait()
        self._raise_fault()
        t0 = time.perf_counter()
        stager = self._stager_fn() or HostStager
        blocks = {}
        for bank, store in self.stores.items():
            if store is None:
                continue
            buf = stager.host_buffer(f"\0clientstore_{bank}",
                                     (len(ids), store.row_dim), np.float32)
            if len(missing) == len(ids):
                store.gather_rows(ids, out=buf)
            else:
                if missing:
                    buf[missing] = store.gather_rows(ids[missing])
                buf[sorted(cached)] = 0.0  # the splice overwrites these
            blocks[f"\0clientstore_{bank}"] = buf
        staged, ready = stager.stage(blocks)
        rows = {bank: staged.get(f"\0clientstore_{bank}", ())
                for bank in BANKS}
        t1 = time.perf_counter()
        with self._lock:
            self._stage_ms += (t1 - t0) * 1e3
        if self.spans is not None:
            self.spans.span_at("clientstore_gather", t0, t1,
                               step=step_of_trace_id(trace_id),
                               trace_id=trace_id)
        return StagedCohort(rows["vel"], rows["err"], version, ready,
                            tuple(sorted(cached.items())))

    @staticmethod
    def splice(cohort: StagedCohort):
        """``(vel, err)`` of a staged cohort with its cached rows copied
        in place at their positions, on the calling thread's current
        stream: call it after that stream has waited on ``cohort.ready``
        (``FederatedSession._consume``)."""
        for pos, pair in cohort.hot:
            for block, row in zip((cohort.vel, cohort.err), pair):
                if row is not None and torch.is_tensor(block):
                    block[pos].copy_(row)
        return cohort.vel, cohort.err

    def is_stale(self, cids, version: int) -> bool:
        """True iff a row of the cohort was scattered after the gather at
        ``version``: the dispatch then gathers again (counted in
        ``regathers``)."""
        ids = np.asarray(cids, np.int64).reshape(-1)
        with self._lock:
            stale = bool((self._last_write[ids] > version).any())
            self.regathers += stale
        return stale

    def scatter(self, cids, new_vel, new_err, trace_id=None) -> None:
        """Write the round's ``[n, D]`` rows back (None or ``()`` for an
        absent bank). Returns at once; ``flush()`` is the fence. On the
        card, call it on the stream that computed the rows, right after
        the round's dispatch."""
        self._raise_fault()
        ids = np.asarray(cids, np.int64).reshape(-1)
        rows = {bank: t for bank, t in zip(BANKS, (new_vel, new_err))
                if self.stores[bank] is not None and torch.is_tensor(t)}
        with self._lock:
            self._version += 1
            self._last_write[ids] = self._version
            if self._cache is not None:
                for pos, cid in enumerate(int(i) for i in ids):
                    # a copy: a view would keep the whole [n, D] alive
                    self._cache.put(cid, tuple(
                        rows[b][pos].clone() if b in rows else None
                        for b in BANKS), dirty=True)
                return
            event = None
            if self.device.type == "cuda":
                if self._wb_stream is None:
                    self._wb_stream = torch.cuda.Stream(self.device)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                for t in rows.values():
                    # the allocator keeps the rows until the worker's
                    # stream is done with them
                    t.record_stream(self._wb_stream)
            entry = _WriteEntry(ids, rows, event, trace_id=trace_id)
            self._pending.append(entry)
            self._ensure_worker()
        self._q.put(entry)

    def flush(self) -> None:
        """The fence: join the pending writebacks, write the dirty cached
        rows through, flush the stores. A ``clientstore_flush`` span on
        the fencing thread (no trace id: it fences every pending
        round)."""
        t0 = time.perf_counter()
        with self._lock:
            waits = list(self._pending)
        for e in waits:
            e.done.wait()
        self._raise_fault()
        with self._lock:
            if self._cache is not None:
                self._cache.flush()
        for store in self.stores.values():
            if store is not None:
                store.flush()
        if self.spans is not None:
            self.spans.span_at("clientstore_flush", t0, time.perf_counter())

    # -- the whole banks (checkpoint, vault): the session's host_vel and
    # host_err properties flush first ---------------------------------------
    def vel_array(self):
        return None if self.vel_store is None else self.vel_store.array()

    def err_array(self):
        return None if self.err_store is None else self.err_store.array()

    def load_vel(self, arr) -> None:
        self._load(self.vel_store, arr)

    def load_err(self, arr) -> None:
        self._load(self.err_store, arr)

    def _load(self, store, arr) -> None:
        if store is None:
            raise ValueError("no such bank in this streamer")
        # drain first: a writeback landing after the load would bring
        # rows from before the restore back over it
        self.flush()
        store.load(arr)
        with self._lock:
            if self._cache is not None:
                self._cache.invalidate()
            # every cohort staged before the load is stale now
            self._version += 1
            self._last_write[:] = self._version

    # ------------------------------------------------------------------------
    def pinned_bytes(self) -> int:
        """The writeback's pinned host buffers, in bytes (the staging
        rings' are the stagers')."""
        return sum(t.nbytes for t in self._wb_host.values())

    def pop_round_stats(self) -> dict:
        """The ``clientstore/*`` scalars since the last call (the same four
        keys every round)."""
        with self._lock:
            if self._cache is not None:
                dh = self._cache.hits - self._hits0
                dm = self._cache.misses - self._misses0
                de = self._cache.evictions - self._evictions0
                self._hits0 = self._cache.hits
                self._misses0 = self._cache.misses
                self._evictions0 = self._cache.evictions
            else:
                dh = dm = de = 0
            out = {
                "clientstore/cache_hit_rate":
                    float(dh) / (dh + dm) if (dh + dm) else 0.0,
                "clientstore/evictions": float(de),
                "clientstore/h2d_stage_ms": self._stage_ms,
                "clientstore/writeback_ms": self._writeback_ms,
            }
            self._stage_ms = 0.0
            self._writeback_ms = 0.0
        return out

    def close(self) -> None:
        """Flush, stop the worker and close the stores (an anonymous mmap
        file is unlinked). Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self.flush()
        finally:
            if self._worker is not None:
                self._q.put(_END)
                self._worker.join(timeout=30)
                self._worker = None
            for store in self.stores.values():
                if store is not None:
                    store.close()


def build_streamer(cfg, row_dim: int, *, needs_vel: bool, needs_err: bool,
                   stager_fn=None, device="cpu", rank: int = 0,
                   group_size: int = 1) -> Optional[CohortStreamer]:
    """The one construction gate: None unless the config hosts client
    state AND a bank is needed (``client_store='device'``, the default,
    builds nothing). In a worker group each rank's streamer holds the
    whole bank, and a named mmap path takes the suffix ``.r<rank>`` so
    that two processes never write one file."""
    if not cfg.client_state_hosted or not (needs_vel or needs_err):
        return None

    def mk(tag):
        path = ""
        if cfg.client_store == "mmap" and cfg.client_store_path:
            path = f"{cfg.client_store_path}.{tag}"
            if group_size > 1:
                path += f".r{rank}"
        return build_store(cfg.client_store, num_rows=cfg.num_clients,
                           row_dim=row_dim, path=path)

    return CohortStreamer(
        vel_store=mk("vel") if needs_vel else None,
        err_store=mk("err") if needs_err else None,
        num_clients=cfg.num_clients,
        cache_rows=cfg.client_store_cache_rows,
        stager_fn=stager_fn, device=device)

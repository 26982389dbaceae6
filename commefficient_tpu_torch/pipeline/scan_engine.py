"""ScanRounds — K rounds a CUDA-graph replay (the port's copy of
``commefficient_tpu/pipeline/scan_engine.py``, ``--scan_rounds K > 1``).

The per-round path pays the host's time for every launch of every round:
the batched client step alone is hundreds of small kernels, and the main
path's round is host-bound (the dispatch is about half of it). This
engine runs blocks of up to K rounds as ONE replay of a CUDA graph
captured from the session's own index round
(``FederatedSession.raw_round_idx_fn``: the round ``train_round_indices``
runs, every input a device tensor), so a block costs the host one launch
of the graph:

* **Inputs staged an epoch at a time.** At an epoch's entry its rounds'
  client ids, sample indices, augment plans, lrs and fedsim environments
  are realized on the host in one pass (each a pure function of the round
  index, the prefetcher's contract) and copied to the device once an
  array. A block's slices are copied into its graph's static input
  buffers before the replay; DP noise is drawn before the replay, with
  the per-round path's generator calls, into the block's static ``[L, w,
  D]`` buffer (a graph cannot replay a seeded ``torch.Generator``), and
  so is the server step's host draw a round (``compressor.round_draw``:
  powersgd's fresh ``Q [m, r]`` without the warm start), staged with the
  epoch's other inputs as ``[n, m, r]`` and read by round i of a block
  from its ``[L, m, r]`` slice.
* **One graph a block length.** ``round_scan_fn[xL]`` is captured once
  for each distinct length L (K, the remainders before a boundary, the
  epoch's tail) over static buffers: the state's leaves are copied into
  the shared static state before a block and out of the graph's outputs
  after it, so a vault rollback or a checkpoint resume replaces the
  session's state and captures nothing. The client banks are the one
  exception: the round updates them in place, so the session's banks
  ARE the static ones, adopted at the first block (a restore copies its
  banks in once). The round's metric dicts are stacked into ``[L]``
  packs in the graph and copied out after each replay (the next replay
  overwrites them before the runner's deferred drain reads them); each
  yielded round's metrics are views of those copies, so the drained
  sequence is the per-round path's. The programs share ONE memory pool
  (the first capture's): they never run at once, their static inputs
  are allocated outside it, each one's outputs stay allocated while its
  graph lives and are copied out right after its replay, before another
  program reuses its temporaries' memory. A pool a program put GPT-2's
  two block lengths (~44 GB each) past the card's 80 GB.
* **Blocks end at every observation boundary.** The runner reads the
  state at checkpoint saves, vault snapshots and epoch ends, so a block
  ends there: the state it sees is the per-round path's bit for bit.
  What would have to act between two arbitrary rounds (the control
  plane, preemption, a fleet resize, a prefetch window) is refused by
  ``Config``.
* **Before the first capture** the plans the kernels read are built
  (``prewarm_rungs``) and one round runs eagerly on scratch copies of the
  state (it trains nothing: the server leaves are cloned, and the client
  banks, which the round writes in place, get their cohort's rows back
  after it), on a side stream, so every library handle,
  plan and kernel module exists before the capture; the round audit, when
  armed, measures that round. cuDNN's benchmark is off during a capture.
  A capture that fails raises: there is no eager fallback on the card.
  ``capture_error_mode="thread_local"``: the runner's other threads (the
  metrics writer, a checkpoint's copies) may call the runtime while a
  block is captured, and must neither abort the capture nor be refused;
  the capturing thread is still checked.
* **Launch accounting.** The kernel wrappers count launches in Python,
  which runs once while a graph is captured and not at all when it is
  replayed: a capture's kernels go to ``capture_counts`` (the program's
  ``launches``), the wrappers' ``launches`` count only the warm-up's
  eager ones, and a replay's launches are measured from a profiler's
  kernel events. ``stats()["replayed_launches"]`` is what the programs
  captured times their replays: the expectation those events are held
  against, not a count.
* **Retraces.** Each capture is noted in the session's
  ``RetraceSentinel`` with its signature (the state leaves' and the
  staged inputs' shapes, dtypes and devices, and L). A block whose
  signature differs from its program's is captured again, which is a
  retrace; ``--max_retraces`` bounds them.

On the CPU (a session built with ``--device cpu``) nothing is captured: a
block runs the same closure as a loop of its rounds, with the same
staging, packs, signatures and sentinel.

``stats()``: rounds, dispatches, rounds per dispatch, the block lengths,
captures, replays, restarts, the staging's host ms an epoch, the
warm-up's launches, the replays' expected launches. At telemetry level >= 1 every round's metrics carry
``pipeline/scan_rounds_per_dispatch``; with spans, each epoch's staging is
a ``scan_stage`` span, each block a ``round_dispatch`` span under its
first round's trace id, and a recovery's fence a
``scan_recovery_restart`` marker.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch

from commefficient_tpu_torch.parallel.round import (
    DeviceEnv,
    FedState,
    client_noise,
    dp_keys,
)
from commefficient_tpu_torch.telemetry.capture import describe_signature
from commefficient_tpu_torch.telemetry.trace import round_trace_id

_LEAVES = ("params_vec", "momentum", "error", "client_vel", "client_err",
           "comp")
_BANKS = ("client_vel", "client_err")


class _Program:
    """One block length's program: the graph (None on the CPU), its static
    inputs and outputs, the launches it captured, its signature."""

    __slots__ = ("L", "name", "graph", "inputs", "state_out", "packs",
                 "launches", "signature")

    def __init__(self, L, name, signature):
        self.L = L
        self.name = name
        self.signature = signature
        self.graph = None
        self.inputs = None
        self.state_out = None
        self.packs = None
        self.launches = {}


def _state_leaves(state: FedState) -> Dict[str, torch.Tensor]:
    return {k: getattr(state, k) for k in _LEAVES
            if torch.is_tensor(getattr(state, k))}


def _slices(staged: dict, o: int, L: int) -> dict:
    """Rounds ``[o, o + L)`` of the epoch's staged arrays."""
    out = {}
    for k, v in staged.items():
        out[k] = (tuple(a[o:o + L] for a in v) if isinstance(v, tuple)
                  else v[o:o + L])
    return out


def _clone(x):
    if isinstance(x, tuple):
        return tuple(a.clone() for a in x)
    return x.clone()


def _copy_into(dst, src) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


class ScanRounds:
    """One per train loop when ``cfg.scan_rounds > 1``, the runner's round
    source with ``PipelinedRounds``' API: ``start(resume_step)``,
    ``epoch_rounds(epoch, start_step, stop_step, before_dispatch)``,
    ``restart(step)``, ``close()``, ``stats()``. ``lr_fn`` is the loop's
    schedule (pure in the round), ``num_rounds`` the last round
    (exclusive) the run dispatches."""

    def __init__(self, cfg, session, sampler, lr_fn, num_rounds: int,
                 steps_per_epoch: Optional[int] = None, spans=None):
        if cfg.scan_rounds <= 1:
            raise ValueError(
                "ScanRounds needs cfg.scan_rounds > 1 (0/1 = the per-round "
                "dispatch path — build nothing)")
        if session.dev_data is None:
            raise ValueError(
                "scan_rounds > 1 needs device-resident data (the index "
                "round): the session attached none — the dataset exceeded "
                "device_data_max_mb, the sampler is not fusable, or the "
                "mode forced host batches. Drop scan_rounds or fix the "
                "device-data gate (FederatedSession.maybe_attach_data).")
        if session.controller is not None:
            raise ValueError(
                "scan_rounds > 1 with a controller should have been "
                "refused at Config validation (per-round pre-dispatch "
                "decisions cannot run inside a scanned block)")
        self.on_card = session.device.type == "cuda"
        self.cfg = cfg
        self.session = session
        self._spans = spans
        self.K = int(cfg.scan_rounds)
        self.num_rounds = int(num_rounds)
        self.steps_per_epoch = int(steps_per_epoch if steps_per_epoch
                                   is not None else sampler.steps_per_epoch())
        self._sampler = sampler
        self._lr_fn = lr_fn
        self._fedsim = session.fedsim_env is not None
        self._dp = cfg.dp_noise_multiplier > 0
        # ONE raw round closure shared by every block length
        self._raw = session.raw_round_idx_fn()
        self._programs: Dict[int, _Program] = {}
        # the one memory pool every program's capture allocates from
        self._pool = None
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._warmed = False
        self._rounds = 0
        self._dispatches = 0
        self._captures = 0
        self._replays = 0
        self._stage_ms = []
        self.restarts = 0
        self.warmup_launches: dict = {}
        self._replayed: dict = {}
        if self.on_card:
            session.prewarm_rungs()  # the kernels' host plans, no launch

    # -- lifecycle (PipelinedRounds' API) ------------------------------------
    def start(self, resume_step: int = 0) -> "ScanRounds":
        del resume_step  # nothing is staged across epoch_rounds calls
        return self

    def restart(self, step: int) -> None:
        """A recovery's fence: nothing is staged across ``epoch_rounds``
        calls, so there is nothing to drop; the runner's re-entry at the
        rollback round stages that epoch's rest again with the session's
        replay horizon. The graphs stay: the restored state is copied into
        their static buffers, so the replay captures nothing."""
        self.restarts += 1
        if self.spans is not None:
            with self.spans.span(f"scan_recovery_restart:round{int(step)}",
                                 step=int(step)):
                pass

    def close(self) -> None:
        """No worker to join; present for the engine API."""

    # -- block plan ---------------------------------------------------------------
    def _boundaries(self):
        """Step multiples a block must not cross (the runner reads
        ``session.state`` there): checkpoint saves and vault snapshots,
        which fire at ``step % every == 0`` with ``step = round + 1``."""
        gates = []
        if self.cfg.checkpoint_every > 0 and self.cfg.checkpoint_dir:
            gates.append(int(self.cfg.checkpoint_every))
        if self.cfg.recovery_enabled:
            gates.append(int(self.cfg.snapshot_every))
        return gates

    def _blocks(self, start: int, stop: int):
        """``[start, stop)`` chopped into blocks of at most K rounds that
        end at every boundary gate: yields ``(block_start, length)``."""
        gates = self._boundaries()
        s = start
        while s < stop:
            e = min(s + self.K, stop)
            for g in gates:
                e = min(e, (s // g + 1) * g)
            yield s, e - s
            s = e

    # -- per-epoch staging ----------------------------------------------------------
    def _stage_range(self, start: int, stop: int):
        """Realize rounds ``[start, stop)``'s inputs on the host (the
        sampler's draws, the plans, the f32 lrs, the fedsim environments
        with the blacklist composed in, replay-aware, and the server
        step's draws: ``compressor.round_draw(r)``, the per-round path's
        own calls) and copy each stacked array to the device once.
        Returns ``(staged, host ids [n, W], fedsim stats a round)``."""
        sess = self.session
        cids, idxs, plans, lrs, draws = [], [], [], [], []
        live, corrupt, count, stats = [], [], [], []
        for r in range(start, stop):
            c, i, p = self._sampler.sample_round_indices(r)
            cids.append(sess._host_ids(c))
            idxs.append(np.asarray(i))
            plans.append(tuple(np.asarray(a) for a in p))
            # the per-round path's f32 lr (_round: float(np.float32(lr)))
            lrs.append(np.float32(float(self._lr_fn(r))))
            draw = sess.compressor.round_draw(r)
            if draw is not None:
                draws.append(draw)
            if self._fedsim:
                env = sess.fedsim_round_env(r, c)
                live.append(np.asarray(env.live, np.float32))
                corrupt.append(np.asarray(env.corrupt, np.float32))
                count.append(np.float32(env.live_count))
                stats.append(dict(env.stats))
            else:
                stats.append(None)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(sess.device)

        staged = {"cids": put(np.stack(cids)), "idx": put(np.stack(idxs)),
                  "plan": tuple(put(np.stack([p[j] for p in plans]))
                                for j in range(len(plans[0]))),
                  "lr": put(np.asarray(lrs, np.float32))}
        if self._fedsim:
            staged.update(live=put(np.stack(live)),
                          corrupt=put(np.stack(corrupt)),
                          count=put(np.asarray(count, np.float32)))
        if draws:  # [n, m, r] f32 (powersgd's Qs), one copy
            staged["draw"] = torch.stack(draws).to(sess.device)
        return staged, np.stack(cids), stats

    def _noise(self, bstart: int, host_cids: np.ndarray) -> torch.Tensor:
        """The block's DP draws, ``[L, w_loc, D]`` (fedavg ``[L, w_loc,
        steps, D]``): round ``bstart + i``'s clients keyed ``(bstart + i,
        client id)`` by the generator calls the per-round path makes."""
        sess, cfg = self.session, self.cfg
        W = cfg.num_workers
        w_loc = W // sess.group.size
        lo = sess.group.rank * w_loc
        # client_noise reads only each client's local-step count
        shape = {"steps": torch.empty((w_loc, cfg.round_microbatches or 1),
                                      device="meta")}
        return torch.stack([
            client_noise(cfg, sess.compressor,
                         dp_keys(bstart + i, ids, lo, w_loc), shape,
                         sess.compressor.d, sess.device)
            for i, ids in enumerate(host_cids)])

    # -- the block program ----------------------------------------------------------
    def _block_fn(self, L: int):
        """The L-round block: ``block(state, inputs) -> (state, packs)``,
        the raw round L times on the block's slices, each metric stacked
        into an ``[L]`` pack."""
        raw, fedsim, dp = self._raw, self._fedsim, self._dp

        def block(state, inp):
            ms = []
            for i in range(L):
                env = (DeviceEnv(inp["live"][i], inp["corrupt"][i],
                                 inp["count"][i]) if fedsim else None)
                state, m = raw(state, inp["cids"][i], inp["idx"][i],
                               tuple(a[i] for a in inp["plan"]),
                               inp["lr"][i], env=env,
                               noise=inp["noise"][i] if dp else None,
                               draw=inp["draw"][i] if "draw" in inp else None)
                ms.append(m)
            return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

        return block

    def _signature(self, L: int, inputs: dict):
        return describe_signature(
            (_state_leaves(self.session.state), inputs), {"L": L})

    def _program(self, L: int, inputs: dict) -> _Program:
        """Block length L's program for this block's signature: the one
        captured before when the signature is the same; else a new capture
        (noted in the sentinel: a second one of a name is a retrace)."""
        sig = self._signature(L, inputs)
        prog = self._programs.get(L)
        if prog is not None and prog.signature == sig:
            return prog
        name = f"round_scan_fn[x{L}]"
        self.session.retrace_sentinel.note(name, sig)
        prog = _Program(L, name, sig)
        if self.on_card:
            self._capture(prog, inputs)
        self._programs[L] = prog
        return prog

    def _static_state(self) -> FedState:
        """The static state every program reads (shared: programs never
        run at once), the session's leaves copied in unless they are the
        static ones already. The client banks are adopted, not cloned:
        the round updates them in place, so the session's banks become the
        static ones (a clone would hold a second ``[num_clients, D]`` copy
        of each), and a restored bank is copied into them."""
        sess = self.session
        if self._static is None or any(
                tuple(self._static[k].shape) != tuple(v.shape)
                or self._static[k].dtype != v.dtype
                for k, v in _state_leaves(sess.state).items()
                if k in self._static):
            self._static = {k: v if k in _BANKS else v.clone()
                            for k, v in _state_leaves(sess.state).items()}
        for k, v in _state_leaves(sess.state).items():
            if self._static[k] is not v:
                self._static[k].copy_(v)
        return replace(sess.state, **self._static)

    def _capture(self, prog: _Program, inputs: dict) -> None:
        from commefficient_tpu_torch.ops.cuda import countsketch as kern

        dev = self.session.device
        state = self._static_state()
        prog.inputs = {k: _clone(v) for k, v in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        before = kern.capture_counts()
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        try:
            torch.cuda.synchronize(dev)
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                prog.state_out, prog.packs = self._block_fn(prog.L)(
                    state, prog.inputs)
        except Exception as e:
            raise RuntimeError(
                f"capturing {prog.name} failed ({type(e).__name__}: {e}); "
                "the scan engine has no eager fallback on the card") from e
        finally:
            torch.backends.cudnn.benchmark = bench
        # what each replay launches (a capture itself launches nothing)
        prog.launches = kern.launches_since(before, kern.capture_counts)
        prog.graph = graph
        if self._pool is None:
            self._pool = graph.pool()
        self._captures += 1

    def _warm_up(self, bstart: int, inputs: dict) -> None:
        """One round on scratch state (it trains nothing): on the card
        before the first capture, on a side stream; the armed round audit
        measures it (on the CPU too, where it is the only reason to run
        it). The server leaves are cloned; the client banks are the
        session's own, which the round writes in place at its cohort's
        rows only, so those rows are saved before it and put back after
        (a clone of a ``[num_clients, D]`` bank would stay in the caching
        allocator's pool)."""
        sess = self.session
        arm = (sess.audit_arm if sess.audit_arm is not None
               and sess.audit_arm.armed else None)
        self._warmed = True
        if not (self.on_card or arm):
            return
        leaves = _state_leaves(sess.state)
        first = _slices(inputs, 0, 1)
        cids = first["cids"][0]
        saved = {k: leaves[k][cids].clone() for k in _BANKS if k in leaves}
        scratch = replace(sess.state, **{k: v.clone() for k, v in
                                         leaves.items() if k not in _BANKS})
        one = self._block_fn(1)
        side = contextlib.nullcontext()
        if self.on_card:
            from commefficient_tpu_torch.ops.cuda import countsketch as kern

            before = kern.form_counts()
            stream = torch.cuda.Stream(sess.device)
            stream.wait_stream(torch.cuda.current_stream(sess.device))
            side = torch.cuda.stream(stream)
        with side:
            with arm.measure(bstart) if arm else contextlib.nullcontext():
                one(scratch, first)
        if self.on_card:
            torch.cuda.current_stream(sess.device).wait_stream(stream)
        for k, rows in saved.items():
            leaves[k][cids] = rows
        if self.on_card:
            torch.cuda.synchronize(sess.device)
            self.warmup_launches = kern.launches_since(before)
        del scratch, saved
        if self.on_card:
            torch.cuda.empty_cache()
        if arm:
            arm.finish()

    def _run_block(self, bstart: int, L: int, inputs: dict):
        """Run rounds ``[bstart, bstart + L)`` and install the new state:
        returns the block's metric packs (copies the next replay cannot
        overwrite)."""
        sess = self.session
        step = int(sess.state.step)  # bstart in the runner's rounds
        if not self._warmed:
            self._warm_up(bstart, inputs)
        prog = self._program(L, inputs)
        if not self.on_card:
            state, packs = self._block_fn(L)(sess.state, inputs)
        else:
            state = self._static_state()
            for k, v in inputs.items():
                _copy_into(prog.inputs[k], v)
            prog.graph.replay()
            for w, forms in prog.launches.items():
                r = self._replayed.setdefault(w, {})
                for f, n in forms.items():
                    r[f] = r.get(f, 0) + n
            out = prog.state_out
            # the banks were updated in place: they stay the static ones
            state = replace(state, **{
                k: (self._static[k] if k in _BANKS else v.clone())
                for k, v in _state_leaves(out).items()})
            packs = {k: v.clone() for k, v in prog.packs.items()}
        sess.state = replace(state, step=step + L)
        self._replays += self.on_card
        return packs

    # -- the runner's round source ----------------------------------------------------
    def epoch_rounds(self, epoch: int, start_step: int, stop_step: int,
                     before_dispatch=None):
        """Yield ``(step, lr, metrics, wait_ms, t_dispatch)`` for epoch
        ``epoch``'s rounds in ``[max(start_step, epoch start),
        min(stop_step, epoch end))``, in order, a block of them a dispatch
        (``before_dispatch(block start)`` just before it). ``wait_ms`` is
        the epoch's staging ms on its first round (0 on the others) and a
        block's rounds share its dispatch time ``t_dispatch``, so the
        runner's ``ms`` puts the whole block on its last round and an
        epoch's rounds still sum to its wall time."""
        sess = self.session
        spe = self.steps_per_epoch
        lo = max(epoch * spe, start_step)
        hi = min((epoch + 1) * spe, stop_step, self.num_rounds)
        if lo >= hi:
            return
        t0 = time.perf_counter()
        with self._span("scan_stage", lo):
            staged, host_cids, host_stats = self._stage_range(lo, hi)
        wait_ms = (time.perf_counter() - t0) * 1e3
        self._stage_ms.append(wait_ms)
        for bstart, L in self._blocks(lo, hi):
            o = bstart - lo
            inputs = _slices(staged, o, L)
            if self._dp:
                inputs["noise"] = self._noise(bstart, host_cids[o:o + L])
            if before_dispatch is not None:
                before_dispatch(bstart)
            if self.spans is not None:
                self.spans.step(bstart)
            t_disp = time.perf_counter()
            with self._span("round_dispatch", bstart,
                            trace_id=round_trace_id(bstart),
                            allocator=sess.device, rounds=L) as sp:
                packs = self._run_block(bstart, L, inputs)
                if sp is not None:
                    sp.fence(packs["loss"])
            sess.mark_dispatched(bstart + L - 1)
            self._rounds += L
            self._dispatches += 1
            for i in range(L):
                s = bstart + i
                metrics = sess.host_round_stats(
                    {k: v[i] for k, v in packs.items()}, host_stats[s - lo])
                if self.cfg.telemetry_level >= 1:
                    metrics["pipeline/scan_rounds_per_dispatch"] = float(L)
                yield s, float(self._lr_fn(s)), metrics, wait_ms, t_disp
                wait_ms = 0.0

    @property
    def spans(self):
        """The span recorder given at construction, else the session's
        as it stands (one attached after the engine was built)."""
        return self._spans if self._spans is not None else self.session.spans

    def _span(self, name: str, step: int, trace_id=None, **detail):
        spans = self.spans
        if spans is None:
            return contextlib.nullcontext()
        return spans.span(name, step=int(step), trace_id=trace_id, **detail)

    # -- stats ----------------------------------------------------------------------------
    def stats(self) -> dict:
        """``rounds``, ``dispatches``, ``rounds_per_dispatch``,
        ``block_lengths`` (the programs), ``captures`` and ``replays`` (0
        on the CPU), ``restarts``, ``stage_ms`` (the mean host ms of an
        epoch's staging), ``warmup_launches`` (the kernels the warm-up
        round launched, ``{wrapper: {form: n}}``), ``replayed_launches``
        (the kernels the replays ran as their captures recorded them, in
        the same form: an expectation to hold a profiler's kernel events
        against), ``captured_launches`` (``{L: launches a replay}``)."""
        return {
            "rounds": self._rounds,
            "dispatches": self._dispatches,
            "rounds_per_dispatch": self._rounds / max(self._dispatches, 1),
            "block_lengths": sorted(self._programs),
            "captures": self._captures,
            "replays": self._replays,
            "restarts": self.restarts,
            "stage_ms": (sum(self._stage_ms) / len(self._stage_ms)
                         if self._stage_ms else 0.0),
            "warmup_launches": self.warmup_launches,
            "replayed_launches": {w: dict(f) for w, f in
                                  self._replayed.items()},
            "captured_launches": {L: p.launches for L, p in
                                  sorted(self._programs.items())},
        }

"""Where a federated round's time goes on the card.

    python -m commefficient_tpu_torch.train.profile_round [--rounds N] \\
        [cv_train flags]

Builds the model, data and session as ``cv_train`` does, with the FetchSGD
main path's flags unless others are given (ResNet-9 at full width, r=5,
c=500,000, k=50,000, 8 clients of 64 images), or, with ``--model gpt2``
(or ``gpt2_tiny``), as ``gpt2_train`` does, with BASELINE #4's flags over
its defaults (GPT-2 small, r=5, c=5,000,000, k=50,000, ``--compute_dtype
bfloat16``, 8 clients of 4 dialogs of 2 candidates of 256 tokens). The cv
flags take every ``cv_train`` model and dataset (``--model fixup_resnet50
--dataset_name imagenet``, ``--dataset_name femnist|cifar100``), and the
training set is attached on the device when ``cv_train`` would attach it.
It runs two
warm-up rounds, then times N rounds of the session's own round function
phase by phase with CUDA events (``build_round_fn``'s ``mark``):

* ``grads``: the W clients' gradients (fedavg: their local SGD steps),
  local momentum and transmits (local_topk: error feedback and top-k),
  summed; or the fused clients' one flattened-batch gradient;
* ``encode``: ``device_encode`` (for sketch: the scramble and K1) and the
  sum over the worker group;
* ``server``: the compressor's server update. Dense sketch decode: the
  table algebra, K2 (the estimates in original order), top-k, the K1
  re-sketch of the extracted update. Sharded (``--topk_method threshold
  --sketch_decode sharded``): the table algebra, K4's range form over
  this rank's slice, the threshold bisection, the compaction, the error
  feedback's re-sketch, the candidate exchange;
* ``apply``: ``w -= delta``, or the sharded decode's k-sparse scatter,
  and the client banks' write-back.

In sketch mode the reference's five asyncfed lines follow
(``async_lines``): a second session of the flags with per-client rows, K
= W // 2, C = 2 and staleness exponent 0.5 (``async_session``) times the
arrival schedule's host ms (``[async arrival]``), one cohort's launch
(``[async launch]``), one W-row staleness-weighted update (``[async
apply]``, with the launch amortized over the updates a cohort feeds), and
the apply chain fenced after every update (``[async sequential]``) and
with the fence deferred one update (``[async double-buffer]``), through
the pair ``AsyncFederation`` dispatches (``async_round_fns``). A failure
there raises.

On the device-resident training set the ``[scan x10]`` line times ten
rounds dispatched one by one against ten as one replay of the scan
engine's CUDA graph (``scan_line``): the dispatch overhead a replay
amortizes, in ms a round. A session the engine does not take is named
and skipped (``scan_skip_reason``); a capture that fails raises.

The phase of a mode's own work is also broken down by step, each step
timed alone (CUDA events around one call, median of 5; host launch gaps
count) on the state after the timed rounds:

* sketch with ``error_type virtual``, dense decode: ``estimate_all``,
  ``topk`` (the selection ``comp.unsketch`` runs: the exact top-k's
  ``nonzero`` form with its scatter, or the threshold bisection),
  ``ef_resketch``, ``rest``; sharded decode: ``k4_estimate``,
  ``bisection``, ``compaction``, ``ef_resketch``, ``exchange_apply``;
* true_topk: ``topk`` and ``rest`` (the momentum and error algebra);
* powersgd: ``products`` (``M @ Q`` and ``M^T @ P_hat``),
  ``gram_schmidt`` and ``rest`` (the algebra, the padding and the rank-r
  reconstruction);
* local_topk, inside the grads phase: ``client_transmit`` (the W clients'
  error feedback, top-k and masking, batched as the round runs them) and
  the rest of the phase;
* fedavg, inside the grads phase: ``local_steps`` (the W clients' local
  SGD steps and their deltas, batched) and the rest of the phase;
  each beside the same work client by client (``..._loop``).

The server steps use the aggregate of one more batch (its clients'
gradients as one flattened batch; only its kind and size matter here).
Then rounds run through the runner's own round source at the flags'
``--pipeline_depth`` (``runner.round_source``: at 0 the sampler's prefetch
thread, at N > 0 the pipelined engine with its staged copies; no metric
read back): two warm-up (``pipeline_depth + 2`` at depth > 0, which
allocate the staging ring), five on the host clock (``round_wall_ms``,
the mean of the runner's round ``ms``: the first timed dispatch to a
device synchronize after the last, over five; ``round_wait_ms`` the mean
wait for a round's inputs), and one through the session's entry under
``torch.profiler``, whose device time is summed by kernel and by kind and
set against ``round_wall_ms`` to give the device's busy share
(``round_busy_share``; not against the profiled round's own wall, which
the profiler lengthens by its host cost per op). The last line of the
output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from contextlib import closing

import numpy as np
import torch

from commefficient_tpu_torch.compress.powersgd import gram_schmidt
from commefficient_tpu_torch.data import FedSampler
from commefficient_tpu_torch.ops.collectives import all_gather_pairs
from commefficient_tpu_torch.ops.countsketch import (
    estimate_all,
    estimate_at_range,
    sketch_sparse,
    sketch_vec,
    topk_scatter,
    unsketch_dense,
)
from commefficient_tpu_torch.ops.topk import (
    compact_nonzero,
    topk_threshold_dense,
    topk_threshold_sharded,
)
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import _to_device, microbatched
from commefficient_tpu_torch.parallel.round import (
    apply_update,
    client_inputs,
    fused_grad_sum,
    make_aggregate_tail,
    make_grad_one,
)
from commefficient_tpu_torch.parallel.round import mask_gpt2
from commefficient_tpu_torch.train import cv_train, gpt2_train
from commefficient_tpu_torch.train.runner import round_source
from commefficient_tpu_torch.utils.config import parse_args

MAIN_PATH = ["--mode", "sketch", "--k", "50000", "--num_rows", "5",
             "--num_cols", "500000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--sketch_backend", "pallas",
             "--num_workers", "8", "--num_devices", "1",
             "--local_batch_size", "64"]
GPT2_PATH = ["--mode", "sketch", "--k", "50000", "--num_rows", "5",
             "--num_cols", "5000000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--compute_dtype", "bfloat16",
             "--num_workers", "8", "--num_devices", "1"]
PHASES = ("grads", "encode", "server", "apply")
# device kernels by kind, first match wins
KINDS = (("countsketch", r"\bcs_\w+_kernel"),
         ("topk", r"topk|sort|radix|bitonic|select"),
         ("conv_gemm", r"conv|gemm|cudnn|xmma|cutlass|wgrad|dgrad|fprop"),
         ("norm", r"norm"),
         ("softmax", r"softmax"),
         ("other", r""))


def _event_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _dense_breakdown(session, agg, lr):
    """The dense sketch decode's server phase step by step (error_type
    virtual, the main path's): the estimates of every coordinate (K2), the
    selection ``comp.unsketch`` runs on them (the exact top-k: the
    ``nonzero`` form ``topk_sparsify`` with its scatter into [D]; the
    threshold top-k: the bisection), the error feedback's re-sketch of the
    extracted update (K1) with its subtraction, and the rest, the momentum
    and error table algebra."""
    cfg, comp, spec, st = (session.cfg, session.compressor, session.spec,
                           session.state)
    rho = cfg.virtual_momentum
    select = (topk_threshold_dense if comp.unsketch is unsketch_dense
              else topk_scatter)

    def algebra():
        m = rho * st.momentum + agg if rho > 0 else agg
        return st.error + lr * m

    e = algebra()
    est = estimate_all(spec, e)
    upd = select(est, cfg.k)
    return {
        "estimate_all": _event_ms(lambda: estimate_all(spec, e)),
        "topk": _event_ms(lambda: select(est, cfg.k)),
        "ef_resketch": _event_ms(lambda: e - sketch_vec(comp._spec_acc,
                                                        upd)),
        "rest": _event_ms(algebra),
    }


def _sharded_breakdown(session, agg, lr):
    """The sharded sketch decode's server phase step by step (error_type
    virtual): K4 over this rank's slice, the threshold bisection, the
    compaction, the error feedback's slice re-sketch with its sum over the
    group, and the candidate exchange with the k-sparse apply."""
    cfg, comp, group, st = (session.cfg, session.compressor, session.group,
                            session.state)
    spec, d = session.spec, session.grad_size
    S = -(-d // group.size)
    start, in_range = comp._slice_coords(group.rank, S, d, agg.device)
    rho = cfg.virtual_momentum
    m = rho * st.momentum + agg if rho > 0 else agg
    e = st.error + lr * m
    est = estimate_at_range(spec, e, start, S) * in_range
    upd = topk_threshold_sharded(est, cfg.k, group)
    loc, val = compact_nonzero(upd, cfg.k)
    gidx = torch.clamp(start + loc, max=d - 1)
    return {
        "k4_estimate": _event_ms(
            lambda: estimate_at_range(spec, e, start, S) * in_range),
        "bisection": _event_ms(
            lambda: topk_threshold_sharded(est, cfg.k, group)),
        "compaction": _event_ms(lambda: compact_nonzero(upd, cfg.k)),
        "ef_resketch": _event_ms(lambda: group.all_reduce_sum(
            sketch_sparse(spec, gidx, val, table_dtype=spec.table_dtype))),
        "exchange_apply": _event_ms(lambda: apply_update(
            st.params_vec, ("sparse", all_gather_pairs(gidx, val, group)))),
    }


def _true_topk_breakdown(session, agg, lr):
    """true_topk's server phase: the top-k of the error-fed accumulator
    (with its scatter into [D]), and the rest, the momentum and error
    algebra and the error's subtraction."""
    cfg, comp, st = session.cfg, session.compressor, session.state
    rho, virtual = cfg.virtual_momentum, cfg.error_type == "virtual"

    def algebra():
        m = rho * st.momentum + agg
        return st.error + lr * m if virtual else m

    e = algebra()
    upd = comp.topk(e, cfg.k)
    return {"topk": _event_ms(lambda: comp.topk(e, cfg.k)),
            "rest": _event_ms(lambda: (algebra(), e - upd))}


def _powersgd_breakdown(session, agg, lr):
    """powersgd's server phase: the two products ``M @ Q`` and ``M^T @
    P_hat``, Gram-Schmidt, and the rest (the momentum and error algebra,
    the padding to [n, m], the rank-r reconstruction and the error's
    subtraction)."""
    cfg, comp, st = session.cfg, session.compressor, session.state
    rho, virtual = cfg.virtual_momentum, cfg.error_type == "virtual"
    Q = st.comp if cfg.powersgd_warm_start else comp._fresh_q(st.step,
                                                              agg.device)

    def matricize():
        m = rho * st.momentum + agg
        e = st.error + lr * m if virtual else m
        M = torch.nn.functional.pad(e, (0, comp.n * comp.m - comp.d))
        return e, M.reshape(comp.n, comp.m)

    e, M = matricize()
    P = M @ Q
    P_hat = gram_schmidt(P)
    Q_new = M.T @ P_hat

    def rest():
        matricize()
        return e - (P_hat @ Q_new.T).reshape(-1)[: comp.d]

    return {"products": _event_ms(lambda: (M @ Q, M.T @ P_hat)),
            "gram_schmidt": _event_ms(lambda: gram_schmidt(P)),
            "rest": _event_ms(rest)}


def _client_breakdown(session, grad_one, batch, ids, lr, grads_ms):
    """The grads phase of the modes with their own per-client work, on
    this rank's clients, batched as the round runs it: local_topk's
    ``client_transmit`` (its error feedback, top-k and momentum masking)
    vmapped over the stacked gradients and bank rows, fedavg's
    ``local_steps`` (``client_grad``: each client's local SGD steps and
    delta) vmapped over the clients' microbatches; beside each, the same
    work client by client (``..._loop``, the plain loop's sum over the
    clients), and the rest of the measured phase."""
    cfg, comp, st = session.cfg, session.compressor, session.state
    w_loc = next(iter(batch.values())).shape[0]
    params, batch, vel, err, lr_c, noise, _, _ = client_inputs(
        cfg, comp, st, ids, batch, lr, lo=session.group.rank * w_loc)
    clients = [{k: v[i] for k, v in batch.items()} for i in range(w_loc)]
    if cfg.round_microbatches:  # fedavg's local steps
        name = "local_steps"
        step = torch.func.vmap(
            lambda b, n: comp.client_grad(grad_one, params, b, n, lr_c),
            in_dims=(0, None if noise is None else 0))
        ms = _event_ms(lambda: step(batch, noise))
        loop_ms = sum(_event_ms(lambda i=i: comp.client_grad(
            grad_one, params, clients[i],
            None if noise is None else noise[i], lr_c))
            for i in range(w_loc))
    else:
        name = "client_transmit"
        g = torch.func.vmap(grad_one, in_dims=(None, 0, None, 0 if noise
                                                is not None else None))(
            params, batch, None, noise)[0]
        u = cfg.local_momentum * vel + g if vel is not None else g
        e_dim = None if err is None else 0
        step = torch.func.vmap(
            lambda u, e: comp.client_transmit(u, e, lr_c),
            in_dims=(0, e_dim), out_dims=(0, 0, e_dim))
        ms = _event_ms(lambda: step(u, err))
        loop_ms = sum(_event_ms(lambda i=i: comp.client_transmit(
            u[i], None if err is None else err[i], lr_c))
            for i in range(w_loc))
    return {name: ms, f"{name}_loop": loop_ms, "rest_of_grads": grads_ms - ms}


SERVER_BREAKDOWNS = {"true_topk": _true_topk_breakdown,
                     "powersgd": _powersgd_breakdown}


def _kind(name: str) -> str:
    return next(k for k, pat in KINDS if re.search(pat, name, re.I))


def entry_round(session, sampler, step: int, lr: float) -> float:
    """Host wall ms of round ``step`` as the runner runs it: the sampler's
    draw, then the session's entry (``train_round_indices`` on the
    device-resident training set, else ``train_round`` on the host batch),
    up to a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if session.data_path == "device":
        session.train_round_indices(*sampler.sample_round_indices(step), lr)
    else:
        ids, batch = sampler.sample_round(step)
        session.train_round(ids, microbatched(session.cfg, batch), lr)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def round_busy_share(session, sampler, step: int, lr: float, warm: int = 2,
                     timed: int = 5) -> dict:
    """The device's busy share of a round as the runner runs it: ``warm``
    rounds (at least ``pipeline_depth + 2``, so the staging ring's pinned
    buffers are allocated before the timing), then ``timed`` rounds
    through the runner's ``round_source`` (the draw in
    the round source's thread, no read-back), whose wall a round
    (``round_wall_ms``) is the mean of the runner's ``ms``: from the first
    timed round's dispatch to a device synchronize after the last, over
    ``timed``; ``round_wait_ms`` is the mean wait for a round's inputs.
    Then one round through ``entry_round`` under ``torch.profiler``, whose
    device kernel time is summed. The share is the device time over the
    unprofiled wall: the profiler's own host cost per op lengthens the
    profiled round (``profiled_round_wall_ms``), most for models of many
    small ops. The rounds start at ``step`` and advance the session's
    state."""
    warm = max(warm, session.cfg.pipeline_depth + 2)
    torch.cuda.synchronize()
    t_first, waits = None, []
    with closing(round_source(session.cfg, session, sampler,
                              lambda s: lr, step,
                              step + warm + timed)) as rounds:
        for i, (_, _, _, wait_ms, t_disp) in enumerate(rounds):
            if i == warm:
                t_first = t_disp
            if i >= warm:
                waits.append(wait_ms)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t_first) / timed
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = entry_round(session, sampler, step + warm + timed, lr)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    return {"round_wall_ms": wall, "round_wait_ms": statistics.mean(waits),
            "pipeline_depth": session.cfg.pipeline_depth,
            "profiled_round_wall_ms": profiled,
            "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / wall,
            "device_ms_by_name": by_name}


SCAN_N = 10  # the [scan xN] line's block length


def scan_skip_reason(session):
    """Why the scan engine does not take ``session`` (the ``[scan xN]``
    line is skipped, naming it), or None: the line then runs, and a
    capture that fails raises."""
    cfg = session.cfg
    if session.data_path != "device":
        return (f"the training set is not on the device (data path "
                f"{session.data_path!r}): the scan engine runs the index "
                f"round")
    if session.controller is not None:
        return "a control plane acts between rounds, which a block cannot"
    return None


def scan_line(session, sampler, n: int, lr: float) -> dict:
    """The reference's ``[scan xN]`` line for the port: ``n`` rounds
    dispatched one by one through ``train_round_indices`` (their index
    draws made before the timing), then ``n`` rounds as ONE replay of the
    scan engine's ``n``-round CUDA graph (``pipeline/scan_engine.py``; its
    epoch's staging inside the timing, the graph captured in an earlier
    replay), each between two device synchronizes: ``{"loop_ms",
    "scan_ms"}`` a round; their difference is the dispatch overhead the
    replay amortizes. Needs the device-resident training set; advances the
    session's state."""
    from commefficient_tpu_torch.pipeline import ScanRounds

    if session.data_path != "device":
        raise ValueError("the scan engine needs the device-resident "
                         "training set (--device_data true within "
                         "--device_data_max_mb)")
    cfg = session.cfg.replace(scan_rounds=n, pipeline_depth=0)
    s0 = int(session.state.step)
    draws = [sampler.sample_round_indices(s0 + i) for i in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, idx, plan in draws:
        session.train_round_indices(ids, idx, plan, lr)
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0) / n
    e = -(-(s0 + n) // n)  # the first epoch of n rounds after the loop
    eng = ScanRounds(cfg, session, sampler, lambda s: lr, (e + 2) * n,
                     steps_per_epoch=n)

    def epoch(i, start):
        for _ in eng.epoch_rounds(i, start, (i + 1) * n):
            pass

    if s0 + n < e * n:  # up to the epoch edge, then a capture
        epoch(e - 1, s0 + n)
    epoch(e, e * n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch(e + 1, (e + 1) * n)
    torch.cuda.synchronize()
    return {"loop_ms": loop_ms,
            "scan_ms": 1e3 * (time.perf_counter() - t0) / n,
            "engine": eng.stats()}


ASYNC_UPDATES = 50  # the [async arrival] line's schedule length


def async_session(cfg, params, loss_fn, mask=None):
    """The async lines' session: ``cfg`` with per-client rows
    (``fuse_clients`` off), K = W // 2, C = 2 and staleness exponent 0.5,
    the reference's settings, whatever ``cfg``'s own async flags."""
    acfg = cfg.replace(fuse_clients=False,
                       async_buffer=max(1, cfg.num_workers // 2),
                       async_concurrency=2, staleness_exponent=0.5)
    return FederatedSession(acfg, params, loss_fn,
                            **({"mask_batch": mask} if mask else {}))


def async_launch(session, ids, batch, lr):
    """One cohort's launch through the session's async pair, as
    ``AsyncFederation`` dispatches a cohort launched at version 0: every
    client's transmit row, the velocity and error rows, the losses and
    the aux rows, ``[W, ...]`` on every rank."""
    launch_fn, _ = session.async_round_fns()
    return launch_fn(session.state, ids, batch, 0, float(np.float32(lr)))


def async_apply(session, out, host_ids, lr):
    """One staleness-weighted server update of the W rows of ``out``
    (``async_launch``'s), every weight 1 (the reference's lines), through
    the session's async pair: sets ``session.state`` and returns the
    update's metrics."""
    _, apply_fn = session.async_round_fns()
    W = session.cfg.num_workers
    session.state, metrics = apply_fn(
        session.state, *out, np.asarray(host_ids, np.int64),
        np.ones(W, np.float32), float(W), float(np.float32(lr)),
        draw=session.server_draw(session.state.step))
    return metrics


def _fence(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def async_lines(session, ids, batch, host_ids, lr: float, reps: int) -> dict:
    """The reference's five asyncfed lines (``scripts/profile_round.py``)
    on the async session ``async_session`` built: ``[async arrival]``,
    the host ms of an ``ASYNC_UPDATES``-update ``AsyncSchedule``;
    ``[async launch]``, one cohort's launch; ``[async apply]``, one
    W-row server update, and the launch amortized over the ``ceil(W /
    K)`` updates a cohort feeds; ``[async sequential]``, the apply chain
    with a fence after every update (the sequential engine), and
    ``[async double-buffer]``, the same chain with each fence deferred
    past the next update's dispatch (``--async_double_buffer``), and their
    difference. Each time is the mean over ``reps`` calls between two
    device synchronizes, after one call to warm it. Nothing is caught: a
    failure raises. Advances ``session.state``; returns the ms by line."""
    from commefficient_tpu_torch.asyncfed import AsyncSchedule

    cfg = session.cfg
    W, K, C = cfg.num_workers, cfg.async_buffer, cfg.async_concurrency
    t0 = time.perf_counter()
    for _ in range(reps):
        AsyncSchedule(seed=cfg.seed, num_workers=W, buffer_k=K,
                      concurrency=C, arrival_rate=1.0,
                      num_updates=ASYNC_UPDATES)
    arrival = (time.perf_counter() - t0) / reps * 1e3
    print(f"[async arrival] {ASYNC_UPDATES}-update host schedule (K={K}, "
          f"C={C}): {arrival:.2f} ms ({arrival / ASYNC_UPDATES * 1e3:.0f} "
          f"us/update)", flush=True)

    def timed(fn):
        out = fn()
        _fence(out)
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        _fence(out)
        return (time.perf_counter() - t) / reps * 1e3

    out = async_launch(session, ids, batch, lr)
    launch = timed(lambda: async_launch(session, ids, batch, lr)[3])
    print(f"[async launch] cohort W={W} grads+encode: {launch:.2f} ms",
          flush=True)
    apply = timed(lambda: async_apply(session, out, host_ids, lr)["loss"])
    per = -(-W // K)
    print(f"[async apply] staleness-weighted {W}-row server update: "
          f"{apply:.2f} ms (launch amortized over ~{per} updates -> "
          f"{launch / per + apply:.2f} ms/update)", flush=True)

    def sequential():
        for _ in range(reps):
            _fence(async_apply(session, out, host_ids, lr)["loss"])

    def double_buffered():
        prev = None
        for _ in range(reps):
            loss = async_apply(session, out, host_ids, lr)["loss"]
            if prev is not None:
                _fence(prev)  # drained after the next apply dispatches
            prev = loss
        _fence(prev)

    chains = {}
    for name, chain in (("sequential", sequential),
                        ("double_buffer", double_buffered)):
        t = time.perf_counter()
        chain()
        chains[name] = (time.perf_counter() - t) / reps * 1e3
    print(f"[async sequential] apply + per-update fence: "
          f"{chains['sequential']:.2f} ms/update", flush=True)
    print(f"[async double-buffer] apply + deferred fence: "
          f"{chains['double_buffer']:.2f} ms/update (overlap delta "
          f"{chains['sequential'] - chains['double_buffer']:+.2f} "
          f"ms/update)", flush=True)
    return {"arrival_ms": arrival, "launch_ms": launch, "apply_ms": apply,
            "amortized_ms": launch / per + apply,
            "sequential_ms": chains["sequential"],
            "double_buffer_ms": chains["double_buffer"]}


def main(argv=None):
    # no abbreviations: "--mode" would be taken for "--model"
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--model", default="resnet9")
    ns, rest = ap.parse_known_args(argv)
    if ns.model.startswith("gpt2"):
        cfg = parse_args(GPT2_PATH + rest, defaults=gpt2_train.DEFAULTS,
                         model=ns.model)
        train, _, _, _, _, params, loss_fn = gpt2_train.build_model_and_data(
            cfg)
        augment, mask = None, mask_gpt2
    else:
        cfg = parse_args(MAIN_PATH + rest, model=ns.model)
        train, _, _, params, loss_fn, augment = (
            cv_train.build_model_and_data(cfg))
        mask = None
    if cfg.client_state_hosted:
        raise ValueError(
            "profile_round splits the round with its client banks on the "
            "card; a hosted store's stage and writeback times are its "
            "clientstore/* scalars (cv_train --telemetry_level 1) — run "
            "profile_round with --client_store device")
    session = FederatedSession(cfg, params, loss_fn,
                               **({"mask_batch": mask} if mask else {}))
    if session.device.type != "cuda":
        raise RuntimeError("profile_round times the card; run it with "
                           "--device cuda on a machine with a GPU")
    dev = session.device
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size,
                         seed=cfg.seed, augment=augment)
    session.maybe_attach_data(train, sampler, augment)
    print(f"model={cfg.model} dataset={cfg.dataset_name} "
          f"D={session.grad_size} data={session.data_path}", flush=True)

    def draw(step):
        ids, batch = sampler.sample_round(step)
        local = session.local_clients(microbatched(cfg, batch))
        return (torch.as_tensor(ids.astype(np.int64), device=dev),
                _to_device(local, dev))

    lr = 0.1  # a mid-schedule lr; the work per round does not depend on it
    with torch.no_grad():
        times = {p: [] for p in PHASES}
        for step in range(2 + ns.rounds):
            ids, batch = draw(step)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            session.state, metrics = session.round_fn(
                session.state, ids, batch, lr, mark=lambda i: ev[i].record(),
                draw=session.server_draw(session.state.step))
            float(metrics["loss"])
            if step >= 2:
                for i, p in enumerate(PHASES):
                    times[p].append(ev[i].elapsed_time(ev[i + 1]))
        phase_ms = {p: statistics.median(v) for p, v in times.items()}
        print(f"mode={cfg.mode} phase medians over", ns.rounds,
              "rounds (ms):", json.dumps(phase_ms), flush=True)

        ids, batch = draw(2 + ns.rounds)
        grad_one = make_grad_one(cfg, loss_fn, session.unravel)
        grads_steps = None
        # local_topk and fedavg: the modes with per-client work
        if not session.compressor.supports_fused_clients:
            grads_steps = _client_breakdown(session, grad_one, batch, ids, lr,
                                            phase_ms["grads"])
            print("grads phase by step (ms):", json.dumps(grads_steps),
                  flush=True)
        server_steps = None
        breakdown = SERVER_BREAKDOWNS.get(cfg.mode)
        if session.compressor.needs_sketch_spec \
                and cfg.error_type == "virtual":
            breakdown = (_sharded_breakdown
                         if session.sketch_decode_resolved == "sharded"
                         else _dense_breakdown)
        if breakdown is not None:
            flat = fused_grad_sum(grad_one, session.state.params_vec, batch)
            tail = make_aggregate_tail(cfg, session.compressor,
                                       session.plan, session.group,
                                       session.grad_size)
            agg = tail(session.compressor.device_encode(flat[0]), *flat[1:],
                       cfg.num_workers // session.group.size)[0]
            server_steps = breakdown(session, agg, lr)
            print("server phase by step (ms):", json.dumps(server_steps),
                  flush=True)
        asynced = None
        if session.compressor.needs_sketch_spec:
            # the buffered-async engine's pieces on their own session
            asess = async_session(cfg, params, loss_fn, mask)
            host_ids, raw = sampler.sample_round(3 + ns.rounds)
            asynced = async_lines(
                asess, torch.as_tensor(host_ids.astype(np.int64),
                                       device=dev),
                _to_device(asess.local_clients(microbatched(cfg, raw)), dev),
                host_ids, lr, ns.rounds)
            del asess
            torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        busy = round_busy_share(session, sampler, 99, lr)
        peak = torch.cuda.max_memory_allocated()
        scan = None
        skip = scan_skip_reason(session)
        if skip is not None:
            print(f"[scan x{SCAN_N}] skipped: {skip}", flush=True)
        else:
            scan = scan_line(session, sampler, SCAN_N, lr)
            tag = cfg.mode + (f"+telemetry_l{cfg.telemetry_level}"
                              if cfg.telemetry_level else "")
            print(f"[scan x{SCAN_N}] full round [{tag}]: "
                  f"{scan['scan_ms']:.2f} ms (per-round dispatch "
                  f"{scan['loop_ms']:.2f} ms; dispatch overhead amortized: "
                  f"{scan['loop_ms'] - scan['scan_ms']:+.2f} ms/round)",
                  flush=True)
    by_name = busy.pop("device_ms_by_name")
    by_kind = {}
    for name, ms in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f} ms  {_kind(name):11s}  {name[:90]}")
    summary = {"model": cfg.model, "mode": cfg.mode,
               "dataset": cfg.dataset_name, "data_path": session.data_path,
               "peak_memory_bytes": peak,
               "decode": session.sketch_decode_resolved,
               "grad_size": session.grad_size,
               "fused_clients": cfg.fuse_clients,
               "phase_ms": phase_ms, "grads_steps_ms": grads_steps,
               "server_steps_ms": server_steps, "async_ms": asynced,
               "bytes_per_round": session.bytes_per_round(),
               **busy, "device_ms_by_kind": by_kind, "scan": scan,
               "card": torch.cuda.get_device_name(0)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

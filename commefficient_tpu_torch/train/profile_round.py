"""Where a federated round's time goes on the card.

    python -m commefficient_tpu_torch.train.profile_round [--rounds N] \\
        [cv_train flags]

Builds the model, data and session as ``cv_train`` does, with the FetchSGD
main path's flags unless others are given (ResNet-9 at full width, r=5,
c=500,000, k=50,000, 8 clients of 64 images), runs two warm-up rounds, then
times N rounds phase by phase with CUDA events:

* ``grads``: the W per-client forward/backward passes and their sum;
* ``encode``: ``device_encode`` (for sketch: the scramble and K1);
* ``server``: the server decode. Dense (sketch): the table algebra, K2
  and the unscramble, top-k, the K1 re-sketch of the extracted update.
  Sharded (``--topk_method threshold --sketch_decode sharded``): the
  table algebra, K4's range form over this rank's slice, the threshold
  bisection, the
  compaction, the error feedback's re-sketch, the candidate exchange;
* ``apply``: ``w -= delta``, or the sharded decode's k-sparse scatter.

With the sharded decode the server phase is also broken down by step
(``k4_estimate``, ``bisection``, ``compaction``, ``ef_resketch``,
``exchange_apply``), each timed alone on the last round's state.

One more round runs under ``torch.profiler``; its device time is summed by
kernel and by kind, and set against the round's wall time to give the
device's busy share. The last line of the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from dataclasses import replace

import torch

from commefficient_tpu_torch.data import FedSampler
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import _to_device
from commefficient_tpu_torch.ops.collectives import all_gather_pairs
from commefficient_tpu_torch.ops.countsketch import (
    estimate_at_range,
    sketch_sparse,
)
from commefficient_tpu_torch.ops.topk import (
    compact_nonzero,
    topk_threshold_sharded,
)
from commefficient_tpu_torch.parallel.round import (
    aggregate,
    apply_update,
    make_grad_one,
    resolve_aggregation,
    server_phase,
    sum_client_grads,
)
from commefficient_tpu_torch.train.cv_train import build_model_and_data
from commefficient_tpu_torch.utils.config import parse_args

MAIN_PATH = ["--mode", "sketch", "--k", "50000", "--num_rows", "5",
             "--num_cols", "500000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--sketch_backend", "pallas",
             "--num_workers", "8", "--num_devices", "1",
             "--local_batch_size", "64"]
PHASES = ("grads", "encode", "server", "apply")
# device kernels by kind, first match wins
KINDS = (("countsketch", r"\bcs_\w+_kernel"),
         ("topk", r"topk|sort|radix|bitonic|select"),
         ("conv_gemm", r"conv|gemm|cudnn|xmma|cutlass|wgrad|dgrad|fprop"),
         ("norm", r"norm"),
         ("other", r""))


def _phased_round(session, grad_one, batch, lr, events):
    """One round, the same steps as ``round_fn``, with an event recorded
    after each phase. Returns ``(loss, agg)``."""
    cfg, comp, group = session.cfg, session.compressor, session.group
    state = session.state
    plan = resolve_aggregation(cfg, comp, group.size)
    events[0].record()
    local, loss_sum, aux = sum_client_grads(grad_one, state.params_vec, batch)
    events[1].record()
    agg, loss, _ = aggregate(cfg, comp, group, local, loss_sum, aux)
    events[2].record()
    update, new_m, new_e = server_phase(cfg, comp, plan, group, state, agg,
                                        lr)
    events[3].record()
    session.state = replace(state,
                            params_vec=apply_update(state.params_vec, update),
                            momentum=new_m, error=new_e, step=state.step + 1)
    events[4].record()
    return loss, agg


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


def _sharded_breakdown(session, agg, lr):
    """The sharded decode's server phase step by step on the session's
    state and the last round's aggregate (error_type virtual, the main
    path's): K4 over this rank's slice, the threshold bisection, the
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
            sketch_sparse(spec, gidx, val))),
        "exchange_apply": _event_ms(lambda: apply_update(
            st.params_vec, ("sparse", all_gather_pairs(gidx, val, group)))),
    }


def _kind(name: str) -> str:
    return next(k for k, pat in KINDS if re.search(pat, name, re.I))


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--rounds", type=int, default=5)
    ns, rest = ap.parse_known_args(argv)
    cfg = parse_args(MAIN_PATH + rest)
    train, _, _, params, loss_fn, augment = build_model_and_data(cfg)
    session = FederatedSession(cfg, params, loss_fn)
    if session.device.type != "cuda":
        raise RuntimeError("profile_round times the card; run it with "
                           "--device cuda on a machine with a GPU")
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.local_batch_size,
                         seed=cfg.seed, augment=augment)
    grad_one = make_grad_one(cfg, loss_fn, session.unravel)
    lr = 0.1  # a mid-schedule lr; the work per round does not depend on it
    with torch.no_grad():
        times = {p: [] for p in PHASES}
        for step in range(2 + ns.rounds):
            batch = _to_device(session.local_clients(
                sampler.sample_round(step)[1]), session.device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            loss, agg = _phased_round(session, grad_one, batch, lr, ev)
            float(loss)
            if step >= 2:
                for i, p in enumerate(PHASES):
                    times[p].append(ev[i].elapsed_time(ev[i + 1]))
        phase_ms = {p: statistics.median(v) for p, v in times.items()}
        print("phase medians over", ns.rounds, "rounds (ms):",
              json.dumps(phase_ms), flush=True)
        server_steps = None
        if (session.sketch_decode_resolved == "sharded"
                and cfg.error_type == "virtual"):
            server_steps = _sharded_breakdown(session, agg, lr)
            print("sharded server phase by step (ms):",
                  json.dumps(server_steps), flush=True)

        batch = sampler.sample_round(99)[1]  # train_round copies it over
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            session.train_round(None, batch, lr)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    by_kind = {}
    for name, ms in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f} ms  {_kind(name):11s}  {name[:90]}")
    summary = {"decode": session.sketch_decode_resolved,
               "phase_ms": phase_ms, "server_steps_ms": server_steps,
               "profiled_round_wall_ms": wall_ms,
               "device_kernel_ms": device_ms,
               "device_busy_share": device_ms / wall_ms if wall_ms else None,
               "device_ms_by_kind": by_kind,
               "card": torch.cuda.get_device_name(0)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""One rank of a gloo worker group, for the port's CPU tests.

Not a test module of its own (it collects nothing): the tests in
tests/test_torch_sharded_decode.py start it twice, and ``spawn`` (used by
tests/test_torch_sparse_aggregate.py and tests/test_torch_fsdp.py) starts
it on 2 or 4 ranks,

    python tests/test_torch_gloo_worker.py RANK WORLD INIT_FILE JOB_JSON \\
        INPUT_NPZ OUTPUT_NPZ

and the tests compare what the ranks write with the JAX package. It
imports only the port (no JAX), so a rank starts in about as long as
torch takes to import.

The job file names the work, each part optional: ``cases``, each a set of
``Config`` keywords for a four-round TinyMLP session fed the client ids,
batches and initial params of the input file (fedavg's batches split into
its local steps), written in the full layout (sharded leaves gathered);
``resume``, cases run two rounds, checkpointed, restored into a fresh
session and run two more (written as ``resume:<name>``); ``topk``, vectors whose
``topk_threshold_sharded`` selection the ranks compute half each;
``ties``, a sharded server update on a table whose estimates tie at the
max for more than k coordinates; ``collectives``, the pair exchanges of
``ops/collectives`` on each rank's row of the input's ``coll/v``;
``telemetry``, cases run as ``cases`` whose every ``diag/*`` scalar is
written a round (``tel:<name>/<key>``, ``[rounds]``; a case with a hosted
client store also writes its banks, ``<name>/host_vel`` and
``<name>/host_err``, and a relative ``client_store_path`` lies in the
job's directory); ``trace``, cases run
through ``run_train_loop`` at telemetry level 1 on the input's
``trace/x`` / ``trace/y`` dataset, rank 0 writing the run dir
(``trace:<name>/run_dir``) and each round's ``xla/exposed_collective_ms``
as the round returned it (``trace:<name>/exposed``), every rank its params
(``trace:<name>/params``); ``control``, cases of the control plane run as
``cases`` with a controller over the input's rounds, written as
``ctl:<name>`` with each round's ``control/rung`` (``ctl:<name>/rungs``)
and the controller's checkpoint blob (``ctl:<name>/blob``).
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tinymlp(params, x):
    """tests/test_round.py's TinyMLP (flax Dense: x @ kernel + bias)."""
    p = params["params"]
    h = torch.relu(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
    return h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]


def _params(npz):
    return {"params": {layer: {leaf: npz[f"{layer}/{leaf}"]
                               for leaf in ("kernel", "bias")}
                       for layer in ("Dense_0", "Dense_1")}}


def _session(kw, npz):
    from commefficient_tpu_torch.models import classification_loss
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.utils.config import Config

    return FederatedSession(Config(**kw, device="cpu"), _params(npz),
                            classification_loss(tinymlp))


def _rounds(sess, npz, lr, rounds):
    from commefficient_tpu_torch.parallel.api import microbatched

    losses = []
    for r in rounds:
        batch = microbatched(sess.cfg, {"x": npz["x"][r], "y": npz["y"][r]})
        losses.append(float(sess.train_round(npz["ids"][r], batch,
                                             lr)["loss"]))
    return losses


def _write_state(out, name, sess, losses):
    """The session's state in the full layout (sharded leaves gathered),
    and whether that layout crosses ``interop`` and back into this rank's
    slices unchanged."""
    from commefficient_tpu_torch.interop import state_from_jax, state_to_jax

    st = sess.full_state()
    mine = sess.state
    sess.set_full_state(state_from_jax(state_to_jax(st)))
    out[f"{name}/interop_roundtrip"] = np.asarray(all(
        (a is None and b is None) or a == b if not torch.is_tensor(a)
        else torch.equal(a, b) for a, b in zip(vars(mine).values(),
                                               vars(sess.state).values())))
    out[f"{name}/losses"] = np.asarray(losses)
    out[f"{name}/params"] = sess.full_params_vec().numpy()
    out[f"{name}/decode"] = np.asarray(sess.sketch_decode_resolved)
    out[f"{name}/aggregate"] = np.asarray(sess.aggregate_resolved)
    out[f"{name}/rank_numel"] = np.asarray([  # what this rank holds
        0 if t is None else t.numel() for t in (
            sess.state.params_vec, sess.state.momentum, sess.state.error)])
    for leaf in ("momentum", "error", "client_vel", "client_err"):
        t = getattr(st, leaf)
        if t is not None:
            out[f"{name}/{leaf}"] = t.numpy()
    for bank in ("host_vel", "host_err"):
        if getattr(sess, bank) is not None:
            out[f"{name}/{bank}"] = np.array(getattr(sess, bank))


def run_cases(job, npz, out, tmp):
    for name, kw in job.get("cases", {}).items():
        if kw.get("client_store_path"):
            kw = {**kw, "client_store_path": os.path.join(
                tmp, kw["client_store_path"])}
        sess = _session(kw, npz)
        losses = _rounds(sess, npz, job["lr"], range(npz["x"].shape[0]))
        _write_state(out, name, sess, losses)
        if kw.get("client_store_path"):  # this rank's own bank files
            out[f"{name}/bank_files"] = np.asarray(sorted(
                f for f in os.listdir(tmp) if f.startswith(
                    os.path.basename(kw["client_store_path"]))))
        sess.close_client_store()


def run_control(job, npz, out):
    from commefficient_tpu_torch.control import build_controller
    from commefficient_tpu_torch.parallel.api import microbatched

    for name, kw in job.get("control", {}).items():
        sess = _session(kw, npz)
        n = npz["x"].shape[0]
        ctrl = build_controller(sess.cfg, sess, n)
        assert ctrl.prewarm() == len(sess.rungs)
        losses, rungs = [], []
        for r in range(n):
            batch = microbatched(sess.cfg, {"x": npz["x"][r],
                                            "y": npz["y"][r]})
            m = sess.train_round(npz["ids"][r], batch, job["lr"])
            losses.append(float(m["loss"]))
            rungs.append(float(m["control/rung"]))
        _write_state(out, f"ctl:{name}", sess, losses)
        out[f"ctl:{name}/rungs"] = np.asarray(rungs)
        out[f"ctl:{name}/blob"] = ctrl.state_blob()


def run_telemetry(job, npz, out):
    from commefficient_tpu_torch.parallel.api import microbatched

    for name, kw in job.get("telemetry", {}).items():
        sess = _session(kw, npz)
        rows = []
        for r in range(npz["x"].shape[0]):
            batch = microbatched(sess.cfg, {"x": npz["x"][r],
                                            "y": npz["y"][r]})
            m = sess.train_round(npz["ids"][r], batch, job["lr"])
            rows.append({k: float(v) for k, v in m.items()
                         if k.startswith("diag/")})
        for k in rows[0]:
            out[f"tel:{name}/{k}"] = np.asarray([row[k] for row in rows])


def run_trace(job, npz, out, tmp):
    from commefficient_tpu_torch.data import FedDataset, FedSampler
    from commefficient_tpu_torch.train.runner import (
        WorkloadHooks,
        run_train_loop,
    )
    from commefficient_tpu_torch.utils.logging import MetricsWriter

    class Hooks(WorkloadHooks):
        def new_accumulator(self):
            return {}

        def accumulate(self, acc, loss, metrics):
            pass

        def evaluate(self):
            return {"loss": 0.0}

        def write_val(self, writer, val, step):
            writer.scalar("val/loss", val["loss"], step)

        def epoch_row(self, **kw):
            return {"epoch": kw["epoch"]}

    for name, kw in job.get("trace", {}).items():
        sess = _session(kw, npz)
        ds = FedDataset({"x": npz["trace/x"], "y": npz["trace/y"]},
                        sess.cfg.num_clients, iid=True, seed=0)
        sampler = FedSampler(ds, num_workers=sess.cfg.num_workers,
                             local_batch_size=sess.cfg.sampler_batch_size,
                             seed=1)
        exposed = []
        round_fn = sess._round

        def traced(*a, _round=round_fn, **k):
            m = _round(*a, **k)
            if "xla/exposed_collective_ms" in m:
                exposed.append(m["xla/exposed_collective_ms"])
            return m

        sess._round = traced
        run_dir = os.path.join(tmp, f"trace_{name}")
        writer = MetricsWriter(run_dir, cfg=sess.cfg) if sess.group.rank \
            == 0 else None
        try:
            run_train_loop(sess.cfg, sess, sampler, Hooks(), writer=writer)
        finally:
            if writer is not None:
                writer.close()
        out[f"trace:{name}/params"] = sess.full_params_vec().numpy()
        if writer is not None:
            out[f"trace:{name}/run_dir"] = np.asarray(run_dir)
            out[f"trace:{name}/exposed"] = np.asarray(exposed)


def run_resume(job, npz, out, tmp):
    """Two rounds, a checkpoint, a fresh session restored from it, two
    more rounds: the state written as ``run_cases`` writes it."""
    from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer

    for name, kw in job.get("resume", {}).items():
        kw = {**kw, "checkpoint_dir": os.path.join(tmp, f"ck_{name}")}
        first = _session(kw, npz)
        losses = _rounds(first, npz, job["lr"], range(2))
        ck = FedCheckpointer(first.cfg)
        ck.maybe_save(first, 2, force=True)
        dist.barrier()  # rank 0's file is on disk before any rank reads
        second = _session(kw, npz)
        assert FedCheckpointer(second.cfg).restore(second) == 2
        losses += _rounds(second, npz, job["lr"], range(2, 4))
        _write_state(out, f"resume:{name}", second, losses)


def run_collectives(job, npz, out, group):
    """``ops/collectives`` on this rank's row of ``coll/v``: each
    exchange's result (every rank's, the tests compare them all)."""
    from commefficient_tpu_torch.ops.collectives import (
        all_gather_pairs,
        compact_pairs,
        psum_segments,
        psum_segments_fused,
        sparse_allreduce,
        sparse_allreduce_sharded,
    )

    c = job.get("collectives")
    if not c:
        return
    v = torch.from_numpy(npz["coll/v"][group.rank])
    cap = c["capacity"]
    out["coll/sparse"] = sparse_allreduce(v, cap, group).numpy()
    out["coll/sparse_seg"] = sparse_allreduce(v, cap, group,
                                              segments=4).numpy()
    out["coll/sharded"] = sparse_allreduce_sharded(v, c["k"], group).numpy()
    if c.get("two_level"):
        out["coll/two_level"] = sparse_allreduce_sharded(
            v, c["k"], group, axis_sizes=c["two_level"]).numpy()
    idx, val = compact_pairs(v, cap)
    for segs in (None, 4):
        g_i, g_v = all_gather_pairs(idx, val, group, segments=segs)
        out[f"coll/gather_idx_{segs}"] = g_i.numpy()
        out[f"coll/gather_val_{segs}"] = g_v.numpy()
    parts = [v[:5].clone(), v[5:].reshape(-1, 1).clone()]
    seg = psum_segments([p.clone() for p in parts], group)
    fused = psum_segments_fused([p.clone() for p in parts], group)
    out["coll/psum_segments_equal"] = np.asarray(
        all(torch.equal(a, b) for a, b in zip(seg, fused)))
    out["coll/psum_segments"] = torch.cat([t.reshape(-1)
                                           for t in seg]).numpy()


def run_topk(job, npz, out, group):
    from commefficient_tpu_torch.ops.topk import topk_threshold_sharded

    for name, k in job.get("topk", {}).items():
        v = torch.from_numpy(npz[f"topk/{name}"])
        S = -(-v.numel() // group.size)
        mine = v[group.rank * S:(group.rank + 1) * S]
        out[f"topk/{name}"] = group.all_gather(
            topk_threshold_sharded(mine, k, group)).numpy()


def run_ties(job, npz, out, group):
    from commefficient_tpu_torch.compress import get_compressor
    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.utils.config import Config

    t = job.get("ties")
    if not t:
        return
    spec = CountSketch(d=t["d"], c=t["c"], r=t["r"], seed=0)
    cfg = Config(**t["config"], device="cpu")
    comp = get_compressor(cfg, d=t["d"], spec=spec)
    g_idx, g_val, _, _, _ = comp.server_update_sharded(
        None, None, None, torch.from_numpy(npz["ties/table"]), 0.1, 0,
        group=group, d=t["d"])
    out["ties/idx"], out["ties/val"] = g_idx.numpy(), g_val.numpy()


def main(argv):
    rank, world, init_file, job_file, in_file, out_file = argv
    sys.path.insert(0, ROOT)
    from commefficient_tpu_torch.parallel.mesh import DistributedWorkers

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=int(rank), world_size=int(world))
    try:
        with open(job_file) as f:
            job = json.load(f)
        npz = dict(np.load(in_file))
        out = {}
        group = DistributedWorkers()
        run_cases(job, npz, out, os.path.dirname(out_file))
        run_telemetry(job, npz, out)
        run_control(job, npz, out)
        run_resume(job, npz, out, os.path.dirname(out_file))
        run_trace(job, npz, out, os.path.dirname(out_file))
        run_topk(job, npz, out, group)
        run_ties(job, npz, out, group)
        run_collectives(job, npz, out, group)
        np.savez(out_file, **out)
    finally:
        dist.destroy_process_group()


def spawn(job, arrays, world: int, tmp_path_factory, timeout: int = 300):
    """Run ``job`` on ``world`` gloo ranks of this script and return each
    rank's outputs. The result is cached by the job's contents in a
    directory every xdist worker of the session shares (under a file
    lock), so test modules that ask for the same job share one spawn."""
    import fcntl
    import hashlib
    import subprocess

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # shared by the session's workers
    key = hashlib.sha256(json.dumps([job, world], sort_keys=True).encode()
                         + b"".join(np.ascontiguousarray(arrays[k]).tobytes()
                                    for k in sorted(arrays))).hexdigest()[:16]
    tmp = base / f"gloo_{key}"
    tmp.mkdir(exist_ok=True)
    outs = [tmp / f"out{rank}.npz" for rank in range(world)]
    with open(tmp / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not all(p.exists() for p in outs):
            (tmp / "job.json").write_text(json.dumps(job))
            np.savez(tmp / "in.npz", **arrays)
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank),
                 str(world), str(tmp / "init"), str(tmp / "job.json"),
                 str(tmp / "in.npz"), str(tmp / f"part{rank}.npz")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for rank in range(world)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=timeout)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for p, log in zip(procs, logs):
                assert p.returncode == 0, log
            for rank in range(world):
                os.replace(tmp / f"part{rank}.npz", outs[rank])
    return [dict(np.load(p)) for p in outs]


if __name__ == "__main__":
    main(sys.argv[1:])

"""One rank of a gloo worker group, for the port's CPU tests.

Not a test module of its own (it collects nothing): the tests in
tests/test_torch_sharded_decode.py start it twice, and ``spawn`` (used by
tests/test_torch_sparse_aggregate.py, tests/test_torch_fsdp.py,
tests/test_torch_multihost.py and others) starts it on 2 or 4 ranks,

    python tests/test_torch_gloo_worker.py RANK WORLD INIT_FILE JOB_JSON \\
        INPUT_NPZ OUTPUT_NPZ

and the tests compare what the ranks write with the JAX package. It
imports only the port (no JAX), so a rank starts in about as long as
torch takes to import.

The job file names the work, each part optional: ``cases``, each a set of
``Config`` keywords for a four-round TinyMLP session fed the client ids,
batches (the first ``num_workers`` of each round) and initial params of
the input file (fedavg's batches split into
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
and the controller's checkpoint blob (``ctl:<name>/blob``); ``multihost``,
cases run as ``cases`` (at telemetry level 1) that also write the worker
group's host axis (``mh:<name>/group``: hosts, host_id,
workers_per_host), round 0's collective counts
(``mh:<name>/collectives``, the ``CollectiveCounter`` snapshot as JSON)
and every round's ``multihost/*`` scalars (``mh:<name>/<key>``,
``[rounds]``; ``mh:<name>/keys`` lists the round's keys);
``foreign_nan``, names of ``cases`` run again on batches laid out by
``multihost.assemble_rows`` from the rank's own host's rows, every row
the rank does not compute NaN (``nan:<name>``, written as ``cases``);
``tp``, the tensor and sequence parallelism of ``parallel/tensor.py``,
``sequence.py`` and ``ring_attention.py`` on grids of the world's ranks
(``run_tp``).

Started as ``python tests/test_torch_gloo_worker.py node INPUT_NPZ
OUTPUT_NPZ FLAGS...`` with the env:// variables of one node of a
two-node cluster (``WORLD_SIZE``, ``RANK``, ``LOCAL_WORLD_SIZE 1``,
``MASTER_ADDR``, ``MASTER_PORT``), a rank is one host of a
``--distributed`` run instead: it joins through the train entries'
bring-up (``parallel.mesh.distributed_from_env``), realizes only its own
host's rows (``HostDataPlane`` and ``assemble_rows``) and writes each
round's client ids and loss and its final params (``node/ids``,
``node/losses``, ``node/params``, ``node/host_id``).
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
    """The input's rounds, each cut to the session's first ``num_workers``
    clients (a session provisioned narrower than the input's cohorts)."""
    from commefficient_tpu_torch.parallel.api import microbatched

    W = sess.cfg.num_workers
    losses = []
    for r in rounds:
        batch = microbatched(sess.cfg, {"x": npz["x"][r][:W],
                                        "y": npz["y"][r][:W]})
        losses.append(float(sess.train_round(npz["ids"][r][:W], batch,
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


def run_multihost(job, npz, out):
    """``multihost``: the host axis of each case's group, round 0's
    collective counts and every round's ``multihost/*`` scalars."""
    from commefficient_tpu_torch.parallel.api import microbatched

    for name, kw in job.get("multihost", {}).items():
        sess = _session(kw, npz)
        g = sess.group
        out[f"mh:{name}/group"] = np.asarray([g.hosts, g.host_id,
                                              g.workers_per_host])
        rows = []
        for r in range(npz["x"].shape[0]):
            batch = microbatched(sess.cfg, {"x": npz["x"][r],
                                            "y": npz["y"][r]})
            if r == 0:
                g.counter.reset()
            m = sess.train_round(npz["ids"][r], batch, job["lr"])
            if r == 0:
                out[f"mh:{name}/collectives"] = np.asarray(json.dumps(
                    g.counter.snapshot(), sort_keys=True))
            rows.append({k: float(v) for k, v in m.items()
                         if k.startswith("multihost/")})
        out[f"mh:{name}/keys"] = np.asarray(sorted(rows[0]), dtype=str)
        for k in rows[0]:
            out[f"mh:{name}/{k}"] = np.asarray([row[k] for row in rows])


def run_foreign_nan(job, npz, out):
    """``foreign_nan``: cases of ``cases`` run again on batches that
    ``multihost.assemble_rows`` lays out from this rank's host's rows
    alone, every row this rank does not compute set to NaN (labels to
    their dtype's max), written as ``nan:<name>``."""
    from commefficient_tpu_torch.multihost import (
        assemble_rows,
        build_topology,
    )

    for name in job.get("foreign_nan", ()):
        sess = _session(job["cases"][name], npz)
        topo = build_topology(sess.cfg)  # this rank's host
        lo, hi = topo.slot_range
        g = sess.group
        losses = []
        for r in range(npz["x"].shape[0]):
            batch = {}
            for k in ("x", "y"):
                a = assemble_rows(g, {topo.host_id: npz[k][r][lo:hi]},
                                  num_hosts=topo.num_hosts)
                per = len(a) // g.size
                foreign = np.ones(len(a), bool)
                foreign[g.rank * per:(g.rank + 1) * per] = False
                a[foreign] = (np.nan if a.dtype.kind == "f"
                              else np.iinfo(a.dtype).max)
                batch[k] = a
            losses.append(float(sess.train_round(npz["ids"][r], batch,
                                                 job["lr"])["loss"]))
        _write_state(out, f"nan:{name}", sess, losses)


def _grid_key(grid) -> str:
    return "x".join(map(str, grid))


def run_tp(job, npz, out):
    """``tp``: on each ``workers x model x seq`` grid of the world's ranks
    (``parallel.mesh.build_grid``), every rank writes what it computes,
    whole (the token blocks gathered over the seq group):

    * ``ring``: ``[W, M, S, causal]`` cases of ``ring_attention`` on the
      input's ``ring/q|k|v`` and the gradient of ``sum(out * ring/w)``
      (``ring:<grid>:<causal>/out|dq|dk|dv``);
    * ``apply``: grids of ``tp_gpt2_apply`` (``apply:<grid>/lm|mc``) and,
      with a seq group, ``sp_gpt2_apply`` (``sp:<grid>/lm|mc``) on the
      ``apply_params`` and ``apply/ids|tt|mc``;
    * ``loss``: grids of ``build_tp_flat_loss`` through
      ``make_grad_one`` on the ``fed_params``: vmapped over the clients of
      ``loss/<key>`` (``[w, B, N, T]``: ``loss:<grid>/grad``, ``/loss``,
      ``/<aux>``) and on client 0 alone with ``batched=False``
      (``loss:<grid>/grad1``, ``/loss1``);
    * ``round``: a ``Config`` of the TP/SP loss's session run over the
      input's ``round/ids`` and ``round/<key>`` rounds (``round/losses``,
      ``round/params``);
    * ``eval``: ``build_tp_eval_fn``'s session metrics over the input's
      ``eval/<i>/<key>`` batches (``eval/<metric>``);
    * ``tp3d``: one ``build_tp3d_train_step`` step a grid on the
      ``apply_params`` and the input's ``tp3d/<key>`` batch: the metrics
      (``tp3d:<grid>/loss|lm_loss|mc_loss``) and each leaf of the rank's
      updated shard tree (``tp3d:<grid>/leaf/<name>``);
    * ``fused_round``: sessions of the sketch-fused backward under the
      TP/SP loss (``fused``, with ``layerwise`` overlap, and the
      dense-grad ``dense`` twin) run over the ``round`` inputs
      (``fused_round:<run>/losses|params``), and round 0's gradient
      table of this rank's clients with weight decay, fused
      (``fused_table/fused``), layerwise (``fused_table/layerwise``, the
      group tables' sum) and the dense gradient's sketch
      (``fused_table/dense``)."""
    tp = job.get("tp")
    if not tp:
        return
    # eight ranks share the CPU: one thread each (a tiny product on many
    # threads is many times slower)
    torch.set_num_threads(1)
    from commefficient_tpu_torch.models import (
        GPT2Config,
        gpt2_shapes,
    )
    from commefficient_tpu_torch.ops.param_utils import (
        make_unravel,
        tree_leaves,
    )
    from commefficient_tpu_torch.parallel import FederatedSession, mask_gpt2
    from commefficient_tpu_torch.parallel.mesh import build_grid
    from commefficient_tpu_torch.parallel.ring_attention import (
        gather_tokens,
        ring_attention,
    )
    from commefficient_tpu_torch.parallel.round import make_grad_one
    from commefficient_tpu_torch.parallel.sequence import sp_gpt2_apply
    from commefficient_tpu_torch.parallel.tensor import (
        build_tp_eval_fn,
        build_tp_flat_loss,
        tp_gpt2_apply,
        tp_shard_params,
    )
    from commefficient_tpu_torch.utils.config import Config

    def model(name):
        gcfg = GPT2Config(**tp[name], dtype=torch.float32)
        unravel = make_unravel(list(tree_leaves(gpt2_shapes(gcfg))))
        vec = torch.from_numpy(npz[f"tp/{name}/params"])
        return gcfg, vec, unravel

    def t(key):
        return torch.from_numpy(npz[key])

    for W, M, S, causal in tp.get("ring", ()):
        grid = build_grid(W, M, S)
        seq = grid.seq
        t_loc = npz["ring/q"].shape[-2] // S
        sl = slice(seq.rank * t_loc, (seq.rank + 1) * t_loc)
        q, k, v = (t(f"ring/{n}")[..., sl, :].clone().requires_grad_(True)
                   for n in "qkv")
        o = ring_attention(q, k, v, seq, causal=bool(causal))
        (o * t("ring/w")[..., sl, :]).sum().backward()
        key = f"ring:{_grid_key((W, M, S))}:{int(causal)}"
        for name, x in (("out", o), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            out[f"{key}/{name}"] = gather_tokens(seq, x.detach(),
                                                 dim=-2).numpy()

    if tp.get("apply"):
        gcfg, vec, unravel = model("apply_cfg")
        ids, tt, mc = t("apply/ids"), t("apply/tt"), t("apply/mc")
        for W, M, S in tp["apply"]:
            grid = build_grid(W, M, S)
            key = _grid_key((W, M, S))
            with torch.no_grad():
                lm, mcl = tp_gpt2_apply(
                    grid, gcfg, tp_shard_params(grid, unravel(vec), gcfg),
                    ids, tt, mc)
                out[f"apply:{key}/lm"], out[f"apply:{key}/mc"] = (
                    lm.numpy(), mcl.numpy())
                if S > 1:
                    lm, mcl = sp_gpt2_apply(grid.seq, gcfg, unravel(vec), ids,
                                            tt, mc)
                    out[f"sp:{key}/lm"], out[f"sp:{key}/mc"] = (
                        lm.numpy(), mcl.numpy())

    if tp.get("loss"):
        gcfg, vec, unravel = model("fed_cfg")
        batch = {k[len("loss/"):]: t(k) for k in npz if k.startswith("loss/")}
        cfg = Config(device="cpu", max_grad_norm=None, weight_decay=0.0)
        for W, M, S in tp["loss"]:
            grid = build_grid(W, M, S)
            key = _grid_key((W, M, S))
            loss_fn = build_tp_flat_loss(gcfg, grid)
            g, loss, aux = torch.func.vmap(
                make_grad_one(cfg, loss_fn, unravel),
                in_dims=(None, 0))(vec, batch)
            out[f"loss:{key}/grad"] = g.numpy()
            out[f"loss:{key}/loss"] = loss.detach().numpy()
            for a, x in aux.items():
                out[f"loss:{key}/{a}"] = x.detach().numpy()
            g1, loss1, _ = make_grad_one(cfg, loss_fn, unravel,
                                         batched=False)(
                vec, {k: v[0] for k, v in batch.items()})
            out[f"loss:{key}/grad1"] = g1.numpy()
            out[f"loss:{key}/loss1"] = loss1.numpy()

    if tp.get("round"):
        r = tp["round"]
        gcfg, vec, unravel = model("fed_cfg")
        cfg = Config(**r["config"], device="cpu")
        grid = build_grid(cfg.num_devices, cfg.model_axis, cfg.seq_axis)
        sess = FederatedSession(
            cfg, unravel(vec.clone()),
            build_tp_flat_loss(gcfg, grid, compute_dtype=r["compute_dtype"]),
            mask_batch=mask_gpt2, grid=grid)
        losses = []
        for i in range(npz["round/ids"].shape[0]):
            b = {k[len("round/"):]: npz[k][i] for k in npz
                 if k.startswith("round/") and k != "round/ids"}
            losses.append(float(sess.train_round(npz["round/ids"][i], b,
                                                 r["lr"])["loss"]))
        out["round/losses"] = np.asarray(losses)
        out["round/params"] = sess.full_params_vec().numpy()

    if tp.get("eval"):
        e = tp["eval"]
        gcfg, vec, unravel = model("fed_cfg")
        cfg = Config(**e["config"], device="cpu")
        grid = build_grid(cfg.num_devices, cfg.model_axis, cfg.seq_axis)
        sess = FederatedSession(
            cfg, unravel(vec.clone()), build_tp_flat_loss(gcfg, grid),
            mask_batch=mask_gpt2, grid=grid,
            eval_fn=build_tp_eval_fn(gcfg, grid, unravel))
        batches = [{k.split("/", 2)[2]: npz[k] for k in npz
                    if k.startswith(f"eval/{i}/")}
                   for i in range(e["batches"])]
        for k, v in sess.evaluate(batches).items():
            out[f"eval/{k}"] = np.asarray(v)

    if tp.get("tp3d"):
        from commefficient_tpu_torch.parallel import build_tp3d_train_step

        gcfg, vec, unravel = model("apply_cfg")
        batch = {k[len("tp3d/"):]: t(k) for k in npz
                 if k.startswith("tp3d/")}
        for W, M, S in tp["tp3d"]["grids"]:
            grid = build_grid(W, M, S)
            key = _grid_key((W, M, S))
            tp_params = tp_shard_params(grid, unravel(vec.clone()), gcfg)
            step = build_tp3d_train_step(grid, gcfg)
            new, metrics = step(tp_params, batch, tp["tp3d"]["lr"])
            assert new is tp_params
            for k, v in metrics.items():
                out[f"tp3d:{key}/{k}"] = v.numpy()
            for name, leaf in tree_leaves(new):
                out[f"tp3d:{key}/leaf/{name}"] = leaf.numpy()

    if tp.get("fused_round"):
        from dataclasses import replace as dc_replace

        from commefficient_tpu_torch.ops.countsketch import sketch_vec
        from commefficient_tpu_torch.parallel.round import (
            OVERLAP_SEGMENTS,
            make_sketch_grad_one,
        )

        r = tp["fused_round"]
        gcfg, vec, unravel = model("fed_cfg")
        base = Config(**r["config"], device="cpu")
        grid = build_grid(base.num_devices, base.model_axis, base.seq_axis)
        loss_fn = build_tp_flat_loss(gcfg, grid)
        runs = {"fused": base,
                "layerwise": base.replace(overlap_collectives="layerwise"),
                "dense": base.replace(sketch_fused_bwd=False)}
        for name in r["runs"]:
            sess = FederatedSession(runs[name], unravel(vec.clone()),
                                    loss_fn, mask_batch=mask_gpt2, grid=grid)
            losses = []
            for i in range(npz["round/ids"].shape[0]):
                b = {k[len("round/"):]: npz[k][i] for k in npz
                     if k.startswith("round/") and k != "round/ids"}
                losses.append(float(sess.train_round(npz["round/ids"][i], b,
                                                     r["lr"])["loss"]))
            out[f"fused_round:{name}/losses"] = np.asarray(losses)
            out[f"fused_round:{name}/params"] = (
                sess.full_params_vec().numpy())
        # round 0's table of this worker rank's clients, weight decay on
        wd = base.replace(weight_decay=r["weight_decay"])
        spec = sess.compressor.spec
        w = grid.workers
        per = base.num_workers // w.size
        flat = {k[len("round/"):]: torch.from_numpy(
            npz[k][0][w.rank * per:(w.rank + 1) * per]) for k in npz
            if k.startswith("round/") and k != "round/ids"}
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in flat.items()}
        d = vec.numel()
        table, _, _ = make_sketch_grad_one(wd, loss_fn, unravel, spec, d)(
            vec, flat)
        groups, _, _ = make_sketch_grad_one(
            wd, loss_fn, unravel, spec, d,
            overlap_segments=OVERLAP_SEGMENTS)(vec, flat)
        g, _, _ = make_grad_one(wd, loss_fn, unravel, batched=False)(vec,
                                                                      flat)
        out["fused_table/fused"] = table.numpy()
        out["fused_table/layerwise"] = torch.stack(groups).sum(0).numpy()
        out["fused_table/dense"] = sketch_vec(
            dc_replace(spec, table_dtype=torch.float32), g).numpy()


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


def node_main(argv):
    """One node of a two-node ``--distributed`` run (module docstring)."""
    in_file, out_file, *flags = argv
    sys.path.insert(0, ROOT)
    from commefficient_tpu_torch.data import FedDataset
    from commefficient_tpu_torch.models import classification_loss
    from commefficient_tpu_torch.multihost import (
        HostDataPlane,
        assemble_rows,
        build_topology,
        global_client_ids,
        make_global_mesh,
        validate_mesh_topology,
    )
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.parallel.mesh import distributed_from_env
    from commefficient_tpu_torch.utils.config import parse_args

    cfg = parse_args(flags)
    npz = dict(np.load(in_file))
    with distributed_from_env(cfg):
        assert dist.is_initialized()
        group = make_global_mesh(cfg)
        topology = build_topology(cfg)  # this rank's host
        validate_mesh_topology(group, topology)
        sess = FederatedSession(cfg, _params(npz),
                                classification_loss(tinymlp))
        ds = FedDataset({"x": npz["node/x"], "y": npz["node/y"]},
                        cfg.num_clients, iid=True, seed=0)
        # every node draws every host's ids (cheap ints); only its own
        # plane realizes batch rows
        planes = [HostDataPlane(ds, build_topology(cfg, host_id=h),
                                local_batch_size=cfg.local_batch_size,
                                seed=cfg.seed)
                  for h in range(cfg.num_hosts)]
        mine = planes[topology.host_id]
        ids_all, losses = [], []
        for r in range(int(npz["node/rounds"])):
            ids = global_client_ids(planes, r)
            local_ids, local_batch = mine.sample_round(r)
            lo, hi = topology.slot_range
            assert np.array_equal(ids[lo:hi], local_ids)
            batch = {k: assemble_rows(group, {topology.host_id: v},
                                      num_hosts=cfg.num_hosts)
                     for k, v in local_batch.items()}
            m = sess.train_round(ids, batch, float(npz["node/lr"]))
            ids_all.append(ids)
            losses.append(float(m["loss"]))
        np.savez(out_file, **{
            "node/ids": np.stack(ids_all), "node/losses": np.asarray(losses),
            "node/params": sess.full_params_vec().numpy(),
            "node/host_id": np.asarray(topology.host_id),
            "node/world": np.asarray(dist.get_world_size())})
    assert not dist.is_initialized()  # the bring-up's group is destroyed


def main(argv):
    if argv[0] == "node":
        return node_main(argv[1:])
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
        run_multihost(job, npz, out)
        run_foreign_nan(job, npz, out)
        run_tp(job, npz, out)
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

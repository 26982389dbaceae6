"""One rank of a two-process gloo worker group, for the port's CPU tests.

Not a test module of its own (it collects nothing): the tests in
tests/test_torch_sharded_decode.py start it twice,

    python tests/test_torch_gloo_worker.py RANK WORLD INIT_FILE JOB_JSON \\
        INPUT_NPZ OUTPUT_NPZ

and compare what the ranks write with the JAX package. It imports only the
port (no JAX), so a rank starts in about as long as torch takes to import.

The job file names the work: ``cases``, each a set of ``Config`` keywords
for a four-round TinyMLP session fed the client ids, batches and initial
params of the input file (fedavg's batches split into its local steps); ``topk``, vectors whose ``topk_threshold_sharded`` selection
the ranks compute half each; ``ties``, a sharded server update on a table
whose estimates tie at the max for more than k coordinates.
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


def run_cases(job, npz, out):
    from commefficient_tpu_torch.models import classification_loss
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.parallel.api import microbatched
    from commefficient_tpu_torch.utils.config import Config

    for name, kw in job["cases"].items():
        sess = FederatedSession(Config(**kw, device="cpu"), _params(npz),
                                classification_loss(tinymlp))
        losses = []
        for r in range(npz["x"].shape[0]):
            batch = microbatched(sess.cfg, {"x": npz["x"][r],
                                            "y": npz["y"][r]})
            losses.append(float(sess.train_round(npz["ids"][r], batch,
                                                 job["lr"])["loss"]))
        out[f"{name}/losses"] = np.asarray(losses)
        out[f"{name}/params"] = sess.state.params_vec.numpy()
        out[f"{name}/decode"] = np.asarray(sess.sketch_decode_resolved)
        for leaf in ("momentum", "error", "client_vel", "client_err"):
            t = getattr(sess.state, leaf)
            if t is not None:
                out[f"{name}/{leaf}"] = t.numpy()


def run_topk(job, npz, out, group):
    from commefficient_tpu_torch.ops.topk import topk_threshold_sharded

    for name, k in job["topk"].items():
        v = torch.from_numpy(npz[f"topk/{name}"])
        S = -(-v.numel() // group.size)
        mine = v[group.rank * S:(group.rank + 1) * S]
        out[f"topk/{name}"] = group.all_gather(
            topk_threshold_sharded(mine, k, group)).numpy()


def run_ties(job, npz, out, group):
    from commefficient_tpu_torch.compress import get_compressor
    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.utils.config import Config

    t = job["ties"]
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
        run_cases(job, npz, out)
        run_topk(job, npz, out, group)
        run_ties(job, npz, out, group)
        np.savez(out_file, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""The quickest proof that the PyTorch / CUDA port runs on an NVIDIA GPU.

Run from the repository root on a machine with one card and ``nvcc``:

    python3 chip_smoke.py

It drives only ``commefficient_tpu_torch`` and imports nothing of JAX. Each
phase prints one line (or a few) and raises on failure, so the script exits
0 only if every phase passed:

1. environment: the card's name and power limit, and the time ``nvcc``
   takes to build the kernels from ``ops/cuda/csrc/``;
2. kernels, at the ResNet-9 FetchSGD geometry (D = 6,573,130, r = 5,
   c = 500,000), for the fmix32 and poly4 hash families: every kernel held
   against its plain PyTorch version on the card (device hash bits exact,
   tables to ``1e-5 * max|table|`` for summation order, estimates and
   medians exact, two K1 launches bit-identical), then timed with CUDA
   events (median of 21 samples of 10 back-to-back calls, warm L2) beside
   its plain version, the PyTorch library call where one exists, and the
   bound from bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s;
3. agreement: a small ResNet-9 FetchSGD session on the card against the
   same session on the CPU (the plain path that the CPU tests hold against
   the JAX package);
4. main path: ``cv_train.main`` with the FetchSGD flags, ResNet-9 at full
   width on the synthetic CIFAR-10 stand-in, 5 rounds and one evaluation,
   with the kernels' launch counters set to 0 just before and read just
   after; then one ``uncompressed`` round.

The last lines are the card (``nvidia-smi``), one JSON object listing every
kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "commefficient_tpu_torch/ops/cuda/csrc/countsketch.cu"
PALLAS = "commefficient_tpu/ops/pallas/countsketch_kernels.py"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
GEOMETRY = dict(d=6_573_130, c=500_000, r=5, band=16, seed=42)
MAIN_ARGS = ["--mode", "sketch", "--k", "50000", "--num_rows", "5",
             "--num_cols", "500000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--sketch_backend", "pallas",
             "--num_workers", "8", "--num_devices", "1",
             "--local_batch_size", "64"]
MAIN_ROUNDS = 5


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(torch, fn, samples: int = 21, calls: int = 10) -> float:
    """Median over ``samples`` of the mean time of ``calls`` back-to-back
    calls, by CUDA events (the queue stays full, so host launch overhead
    hides behind the device's work)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def bound(nbytes: float, f32_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def kernels_phase(torch, cs, kern, dev):
    """Holds K1-K3 against their plain versions for both hash families,
    and times them at the main path's family (fmix32). Returns the
    ``kernels`` entries without ``launches``."""
    entries = {}
    for family in ("fmix32", "poly4"):
        spec = cs.CountSketch(hash_family=family, **GEOMETRY)
        # device hash functions == host hash functions, bit for bit
        g = torch.Generator().manual_seed(7)
        hi = 2**31 - 1 if family == "poly4" else 2**32
        x = torch.cat([torch.randint(0, hi, (1 << 20,), generator=g),
                       torch.arange(hi - 512, hi), torch.arange(512)])
        for row in range(spec.r):
            key = spec._row_key(row)
            for which, purpose, k in (("slot", 0, key),
                                      ("sign", 1, key ^ 0x9E3779B9)):
                want = (cs.poly4(x, spec._poly4_coeffs(row, purpose))
                        if family == "poly4" else cs.mix32(x, k))
                got = kern.hash_bits_cuda(spec, row, x.to(dev), which)
                check(bool((torch.from_numpy(got.astype("int64"))
                            == want).all()),
                      f"{family} {which} hash bits differ on row {row}")

        gen = torch.Generator(device=dev).manual_seed(0)
        v = torch.randn(spec.d, generator=gen, device=dev)
        v_s = cs._scramble(spec, v)
        # K1
        t_k = kern.sketch_rows(spec, v_s)
        t_k2 = kern.sketch_rows(spec, v_s)
        t_p = kern.sketch_rows_torch(spec, v_s)
        torch.cuda.synchronize()
        err1 = float((t_k - t_p).abs().max())
        tol1 = 1e-5 * max(1.0, float(t_p.abs().max()))
        check(err1 <= tol1, f"K1 {family}: max err {err1} > {tol1}")
        check(torch.equal(t_k, t_k2), f"K1 {family}: two launches differ")
        # K2, on the kernel's own table (the main path's input)
        e_k = kern.estimate_median(spec, t_k)
        e_p = kern.estimate_median_torch(spec, t_k)
        torch.cuda.synchronize()
        err2 = float((e_k - e_p).abs().max())
        check(err2 == 0.0, f"K2 {family}: max err {err2} (expected exact)")
        # K3 on the [r, d_eff] stack of per-row estimates
        maps = kern._plain_maps(spec, str(v_s.device))
        stack = torch.stack([t_k[row][cols] * sign
                             for row, (cols, sign) in enumerate(maps)])
        m_k = kern.median_rows(stack)
        m_p = kern.median_rows_torch(stack)
        torch.cuda.synchronize()
        err3 = float((m_k - m_p).abs().max())
        check(err3 == 0.0, f"K3 {family}: max err {err3} (expected exact)")
        check(torch.equal(m_k, e_k), f"K3 {family}: median of the per-row "
              "estimates differs from K2's fused estimate")
        phase("kernels", family=family, k1_max_abs_err=err1, k1_tol=tol1,
              k1_bit_identical_rerun=True, k2_max_abs_err=err2,
              k3_max_abs_err=err3, hash_bits="exact")
        if family != "fmix32":
            continue

        r, c, d_eff = spec.r, spec.c_actual, spec.d_eff
        ptr, off = kern._kernel_geometry(spec, str(v_s.device))[1:]
        csr_bytes = 4 * (ptr.numel() + off.numel())
        # K1's library yardstick: ONE index_add_ of all rows into the
        # flattened table (signed sources and flat columns precomputed)
        flat_cols = torch.cat([row * c + cols for row, (cols, _)
                               in enumerate(maps)])
        flat_src = torch.cat([v_s * sign for _, sign in maps])
        flat_table = torch.zeros(r * c, device=dev)
        lib1 = cuda_ms(torch, lambda: flat_table.index_add_(0, flat_cols,
                                                            flat_src))
        b1, by1 = bound(4 * d_eff + 4 * r * c + csr_bytes, r * d_eff)
        b2, by2 = bound(4 * r * c + 4 * d_eff, r * d_eff
                        + r * (r - 1) * d_eff)
        b3, by3 = bound(4 * r * d_eff + 4 * d_eff, r * (r - 1) * d_eff)
        entries["cs_sketch_rows"] = dict(
            replaces=f"{PALLAS}:221", max_abs_err=err1,
            ms=cuda_ms(torch, lambda: kern.sketch_rows(spec, v_s)),
            plain_ms=cuda_ms(torch, lambda: kern.sketch_rows_torch(spec,
                                                                   v_s)),
            bound_ms=b1, bound_by=by1, library_ms=lib1)
        entries["cs_estimate_median"] = dict(
            replaces=f"{PALLAS}:306", max_abs_err=err2,
            ms=cuda_ms(torch, lambda: kern.estimate_median(spec, t_k)),
            plain_ms=cuda_ms(torch, lambda: kern.estimate_median_torch(
                spec, t_k)),
            bound_ms=b2, bound_by=by2, library_ms=None)
        entries["median_rows"] = dict(
            replaces=f"{PALLAS}:341", max_abs_err=err3,
            ms=cuda_ms(torch, lambda: kern.median_rows(stack)),
            plain_ms=cuda_ms(torch, lambda: kern.median_rows_torch(stack)),
            bound_ms=b3, bound_by=by3,
            library_ms=cuda_ms(torch, lambda: torch.median(stack, 0)))
        for name, e in entries.items():
            phase("timing", kernel=name, ms=e["ms"], plain_ms=e["plain_ms"],
                  library_ms=e["library_ms"], bound_ms=e["bound_ms"],
                  bound_by=e["bound_by"])
        del flat_cols, flat_src, flat_table, stack
    return entries


def agreement_phase(torch, np, dev):
    """Three FetchSGD rounds of a width-8 ResNet-9 in float32 on the card
    and on the CPU from the same params and batches. The CPU path is the
    one the CPU tests hold against the JAX package; the card sums buckets
    and convolutions in another order, and a near-tie at the k-th place may
    pick another coordinate, so params agree within 1e-3 of how far they
    moved and losses within rtol 1e-4."""
    from commefficient_tpu_torch.data import (CIFAR10_MEAN, CIFAR10_STD,
                                              normalizer)
    from commefficient_tpu_torch.models import (classification_loss,
                                                init_resnet9, resnet9_apply)
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.utils.config import Config

    def apply32(p, x):
        return resnet9_apply(p, x, dtype=torch.float32)

    loss_fn = classification_loss(apply32, prep=normalizer(CIFAR10_MEAN,
                                                           CIFAR10_STD))
    params = init_resnet9(3, width=8)
    rng = np.random.default_rng(3)
    batches = [{"x": rng.integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8),
                "y": rng.integers(0, 10, (2, 8)).astype(np.int32)}
               for _ in range(3)]
    out = {}
    for where in (dev.type, "cpu"):
        cfg = Config(mode="sketch", k=2000, num_rows=5, num_cols=20_000,
                     virtual_momentum=0.9, error_type="virtual",
                     num_workers=2, num_clients=4, local_batch_size=8,
                     compute_dtype="float32", device=where)
        sess = FederatedSession(cfg, params, loss_fn)
        p0 = sess.state.params_vec.cpu().clone()
        losses = [float(sess.train_round(None, b, 0.2)["loss"])
                  for b in batches]
        out[where] = (losses, p0, sess.state.params_vec.cpu())
    (l_dev, p0, p_dev), (l_cpu, _, p_cpu) = out[dev.type], out["cpu"]
    moved = float(torch.linalg.vector_norm(p_cpu - p0))
    diff = float(torch.linalg.vector_norm(p_dev - p_cpu))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    phase("agreement", D=p0.numel(), losses_card=l_dev, losses_cpu=l_cpu,
          loss_max_rel_err=loss_rel, params_diff_over_moved=diff / moved)
    check(moved > 0, "agreement: params did not move")
    check(loss_rel <= 1e-4, f"agreement: loss rel err {loss_rel} > 1e-4")
    check(diff <= 1e-3 * moved,
          f"agreement: |p_card - p_cpu| = {diff} > 1e-3 * {moved}")


def main_path_phase(kern, cv_train, dataset_dir):
    kern.reset_launch_counts()
    out = cv_train.main(MAIN_ARGS + ["--max_rounds", str(MAIN_ROUNDS),
                                     "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    phase("main_path", D=out["grad_size"],
          upload_bytes_per_client=out["bytes_per_round"]["upload_bytes"],
          download_bytes_per_client=out["bytes_per_round"]["download_bytes"],
          rounds=len(hist), round_ms=[round(h["ms"], 3) for h in hist],
          losses=losses, val_loss=out["loss"],
          val_acc=out.get("accuracy"), param_delta_norm=out[
              "param_delta_norm"], launches=launches)
    check(out["grad_size"] == GEOMETRY["d"], "main path: unexpected D")
    check(len(hist) == MAIN_ROUNDS, "main path: wrong number of rounds")
    check(all(math.isfinite(x) for x in losses), "main path: loss not finite")
    check(math.isfinite(out["loss"]), "main path: eval loss not finite")
    check(out["param_delta_norm"] > 0, "main path: params did not move")
    check(launches["sketch_rows"] == 2 * MAIN_ROUNDS,
          f"main path: K1 launched {launches['sketch_rows']} times, "
          f"expected 2 per round")
    check(launches["estimate_median"] == MAIN_ROUNDS,
          f"main path: K2 launched {launches['estimate_median']} times, "
          f"expected 1 per round")
    return launches


def uncompressed_phase(kern, cv_train, dataset_dir):
    args = list(MAIN_ARGS)
    args[args.index("sketch")] = "uncompressed"
    for flag in ("--error_type", "--k", "--num_rows", "--num_cols"):
        i = args.index(flag)
        del args[i:i + 2]
    kern.reset_launch_counts()
    out = cv_train.main(args + ["--max_rounds", "1", "--dataset_dir",
                                dataset_dir])
    loss = out["history"][0]["loss"]
    phase("uncompressed", loss=loss, round_ms=out["history"][0]["ms"],
          launches=kern.launch_counts())
    check(math.isfinite(loss) and out["param_delta_norm"] > 0,
          "uncompressed round: loss not finite or params did not move")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from commefficient_tpu_torch import resolve_device
    from commefficient_tpu_torch.ops import countsketch as cs
    from commefficient_tpu_torch.ops.cuda import build
    from commefficient_tpu_torch.ops.cuda import countsketch as kern
    from commefficient_tpu_torch.train import cv_train

    dev = resolve_device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    build.load_library()
    phase("environment", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, gpu=repr(torch.cuda.get_device_name(0)),
          build_s=round(time.perf_counter() - t0, 3),
          nvcc_s=build.build_seconds, library=build.library_path().name)

    entries = kernels_phase(torch, cs, kern, dev)
    agreement_phase(torch, np, dev)
    # a path with no CIFAR-10 pickles: the synthetic stand-in
    dataset_dir = os.path.join(ROOT, "build", "no_dataset")
    launches = main_path_phase(kern, cv_train, dataset_dir)
    uncompressed_phase(kern, cv_train, dataset_dir)

    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    launches=launches[{"cs_sketch_rows": "sketch_rows",
                                       "cs_estimate_median":
                                           "estimate_median",
                                       "median_rows": "median_rows"}[name]],
                    **e)
               for name, e in entries.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

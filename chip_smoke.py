#!/usr/bin/env python3
"""The quickest proof that the PyTorch / CUDA port runs on an NVIDIA GPU.

Run from the repository root on a machine with one card and ``nvcc``:

    python3 chip_smoke.py

It drives only ``commefficient_tpu_torch`` and imports nothing of JAX. Each
phase prints one line (or a few) and raises on failure, so the script exits
0 only if every phase passed:

1. environment: the card's name and power limit, the time ``nvcc``
   takes to build the kernels from ``ops/cuda/csrc/``, and each kernel's
   registers, static shared memory and spills from the build's ptxas
   report;
2. kernels, at the ResNet-9 FetchSGD geometry (D = 6,573,130, r = 5,
   c = 500,000), for the fmix32 and poly4 hash families: every kernel held
   against its plain PyTorch version on the card (device hash bits exact,
   tables to ``1e-5 * max|table|`` for summation order, estimates and
   medians exact, two K1 launches bit-identical), then timed with CUDA
   events (median of 21 samples of 10 back-to-back calls, warm L2) beside
   its plain version, the PyTorch library call where one exists, and the
   bound from bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s; K1 is
   also timed as its gather kernel (one thread per column, the design
   before the tile kernel), K2 is the in-call control;
   K4 (``estimate_at``) is held to its plain version exactly at three
   geometries (every coordinate of the main path, where it must also equal
   K2 unscrambled; 50,000 coordinates of it; a 100 MB table at 31M
   coordinates), both hash families, and timed at each; its range form
   (``estimate_at_range``, the sharded decode's) is held exactly to the
   explicit-index form at the clipped indices, at every coordinate (i) and
   at the last rank's slice of a four-way split, and timed at (i);
3. agreement: a small ResNet-9 FetchSGD session on the card against the
   same session on the CPU (the plain path that the CPU tests hold against
   the JAX package), for the dense decode and for the sharded decode with
   the threshold top-k, and the card's sharded decode against its dense
   threshold decode (atol 1e-6);
4. replay: two sharded server updates from one state at full width are
   bit-identical;
5. main paths: ``cv_train.main`` with the FetchSGD flags, ResNet-9 at full
   width on the synthetic CIFAR-10 stand-in, 5 rounds and one evaluation,
   with the kernels' launch counters set to 0 just before and read just
   after: first the dense decode (K1 twice a round, K2 once), then the
   sharded decode (``--topk_method threshold --sketch_decode sharded``,
   one device: K1 twice a round, K4's range form once, K2 never); then
   one ``uncompressed`` round.

The last lines are the card (``nvidia-smi``), one JSON object listing every
kernel (``launches`` summed over both main paths, ``launches_by_path``
beside it), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "commefficient_tpu_torch/ops/cuda/csrc/countsketch.cu"
PALLAS = "commefficient_tpu/ops/pallas/countsketch_kernels.py"
DECODE_PALLAS = "commefficient_tpu/ops/pallas/decode_kernels.py"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
GEOMETRY = dict(d=6_573_130, c=500_000, r=5, band=16, seed=42)
MAIN_ARGS = ["--mode", "sketch", "--k", "50000", "--num_rows", "5",
             "--num_cols", "500000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--sketch_backend", "pallas",
             "--num_workers", "8", "--num_devices", "1",
             "--local_batch_size", "64"]
SHARDED_FLAGS = ["--topk_method", "threshold", "--sketch_decode", "sharded"]
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


def kernels_phase(torch, cs, kern, build, index_math, dev):
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
        rows, ptr, off, tile = kern._kernel_geometry(spec, str(v_s.device))[:4]
        csr_bytes = 4 * (ptr.numel() + off.numel())
        lib = build.load_library()

        def k1_gather():  # K1's gather kernel: tile width 0
            table = torch.empty(spec.table_shape, device=dev)
            kern._launch(lib.cs_sketch_rows, v_s.data_ptr(), d_eff,
                         ptr.data_ptr(), off.data_ptr(), table.data_ptr(), c,
                         rows, r, 0, 0, kern._stream())
            return table

        check(torch.equal(k1_gather(), t_k), "K1: the tile and gather "
              "kernels' tables differ")
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
        smem1 = max(index_math.sketch_smem_bytes(
            spec.chunk_m, spec.V_row(row), tile * spec.s_row(row))
            for row in range(r))
        entries["cs_sketch_rows"] = dict(
            replaces=f"{PALLAS}:221", max_abs_err=err1,
            ms=cuda_ms(torch, lambda: kern.sketch_rows(spec, v_s)),
            plain_ms=cuda_ms(torch, lambda: kern.sketch_rows_torch(spec,
                                                                   v_s)),
            bound_ms=b1, bound_by=by1, library_ms=lib1,
            gather_kernel_ms=cuda_ms(torch, k1_gather),
            tile_strides=tile, dynamic_smem_bytes=smem1)
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
                  bound_by=e["bound_by"], **{k: e[k] for k in (
                      "gather_kernel_ms", "tile_strides") if k in e})
        del flat_cols, flat_src, flat_table, stack
    return entries


def agreement_phase(torch, np, dev):
    """Three FetchSGD rounds of a width-8 ResNet-9 in float32 on the card
    and on the CPU from the same params and batches. The CPU path is the
    one the CPU tests hold against the JAX package; the card sums buckets
    and convolutions in another order, and a near-tie at the k-th place may
    pick another coordinate, so params agree within 1e-3 of how far they
    moved and losses within rtol 1e-4."""
    l_dev, p0, p_dev, _ = _width8_session(torch, np, dev.type)
    l_cpu, _, p_cpu, _ = _width8_session(torch, np, "cpu")
    moved = float(torch.linalg.vector_norm(p_cpu - p0))
    diff = float(torch.linalg.vector_norm(p_dev - p_cpu))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    phase("agreement", D=p0.numel(), losses_card=l_dev, losses_cpu=l_cpu,
          loss_max_rel_err=loss_rel, params_diff_over_moved=diff / moved)
    check(moved > 0, "agreement: params did not move")
    check(loss_rel <= 1e-4, f"agreement: loss rel err {loss_rel} > 1e-4")
    check(diff <= 1e-3 * moved,
          f"agreement: |p_card - p_cpu| = {diff} > 1e-3 * {moved}")


def k4_phase(torch, cs, kern, dev):
    """Holds K4 (``estimate_at``) against its plain version, exactly, for
    both hash families at three geometries: (i) the main path, every
    coordinate of the ResNet-9 geometry (and there also against K2
    unscrambled); (ii) 50,000 random coordinates of it (the dampening and
    k-scale shape); (iii) a table over the reference's single-block VMEM
    guard, r = 5, c = 5,000,000, d = 124,000,000, at 31,000,000 random
    coordinates (one shard of a four-card decode). At (i) K4's range form
    (``estimate_at_range``, no index array) is held exactly to the
    explicit-index form at the same clipped indices, at every coordinate
    and at the last rank's slice of a four-way split (the clip at d - 1
    bites). Times them at the main path's family (fmix32); the range form
    at (i) is "i_range". Returns the ``kernels`` entry without
    ``launches``."""
    geometries = {
        "i_main_all_coords": (GEOMETRY, None),
        "ii_main_50k_coords": (GEOMETRY, 50_000),
        "iii_table_100MB_31M_coords": (dict(d=124_000_000, c=5_000_000, r=5,
                                            band=16, seed=42), 31_000_000),
    }
    timings, worst = {}, 0.0
    for family in ("fmix32", "poly4"):
        for name, (geo, n) in geometries.items():
            spec = cs.CountSketch(hash_family=family, **geo)
            gen = torch.Generator(device=dev).manual_seed(5)
            table = torch.randn(spec.table_shape, generator=gen, device=dev)
            idx = (torch.arange(spec.d, device=dev) if n is None else
                   torch.randperm(spec.d, generator=gen, device=dev)[:n])
            got = kern.estimate_at(spec, table, idx)
            want = kern.estimate_at_torch(spec, table, idx)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.equal(got, want),
                  f"K4 {family} {name}: max err {err} (expected exact)")
            fields = {}
            if n is None:
                full = cs._unscramble(spec, kern.estimate_median(spec, table))
                check(torch.equal(got, full), f"K4 {family}: estimate_at of "
                      "every coordinate differs from K2 unscrambled")
                fields["equals_k2_unscrambled"] = True
                S = -(-spec.d // 4)
                for start, cnt in ((0, spec.d), (3 * S, S)):
                    rng_out = kern.estimate_at_range(spec, table, start, cnt)
                    explicit = kern.estimate_at(spec, table, torch.clamp(
                        start + torch.arange(cnt, device=dev),
                        max=spec.d - 1))
                    torch.cuda.synchronize()
                    check(torch.equal(rng_out, explicit),
                          f"K4 range form {family} start={start} n={cnt}: "
                          "differs from the explicit-index form")
                fields["range_form_equals_explicit"] = "all coords, last " \
                    "rank of 4"
            phase("k4", family=family, geometry=name, n=idx.numel(),
                  table_bytes=4 * table.numel(), max_abs_err=err, **fields)
            if family == "fmix32":
                nn = idx.numel()
                r, c = spec.table_shape
                perm = 4 * (spec.d_eff // spec.sblock)
                b, by = bound(8 * nn + 4 * nn + min(4 * r * c, 32 * r * nn)
                              + min(perm, 32 * nn),
                              r * nn + r * (r - 1) * nn)
                light = nn > 10_000_000  # the plain version is slow there
                timings[name] = dict(
                    n=nn, max_abs_err=err,
                    ms=cuda_ms(torch, lambda: kern.estimate_at(spec, table,
                                                               idx)),
                    plain_ms=cuda_ms(
                        torch, lambda: kern.estimate_at_torch(spec, table,
                                                              idx),
                        samples=5 if light else 21, calls=2 if light else 10),
                    bound_ms=b, bound_by=by)
                phase("timing", kernel="cs_estimate_at", geometry=name,
                      **timings[name])
                if n is None:
                    plan = kern._range_plan(spec, 0, nn, str(dev))
                    b, by = bound(4 * nn + 4 * r * c + perm
                                  + 4 * plan["blocks"].numel(),
                                  r * nn + r * (r - 1) * nn)
                    timings["i_range"] = dict(
                        n=nn, max_abs_err=err,
                        ms=cuda_ms(torch, lambda: kern.estimate_at_range(
                            spec, table, 0, nn)),
                        plain_ms=cuda_ms(
                            torch, lambda: kern.estimate_at_range_torch(
                                spec, table, 0, nn)),
                        bound_ms=b, bound_by=by,
                        staged_rows=list(plan["staged"]),
                        dynamic_smem_bytes=4 * sum(plan["wlen"]))
                    phase("timing", kernel="cs_estimate_at (range form)",
                          geometry="i_range", **timings["i_range"])
            worst = max(worst, err)
            del table, idx, got, want
    main = timings["i_range"]  # the sharded main path's form and shape
    return dict(replaces=f"{DECODE_PALLAS}:164 and :227", max_abs_err=worst,
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, geometries=timings)


def _width8_session(torch, np, where, **cfg_kw):
    """(losses, p0, final params) of three FetchSGD rounds of a width-8
    ResNet-9 in float32 on ``where``, from fixed params and batches."""
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
    cfg = Config(mode="sketch", k=2000, num_rows=5, num_cols=20_000,
                 virtual_momentum=0.9, error_type="virtual", num_workers=2,
                 num_clients=4, local_batch_size=8, compute_dtype="float32",
                 device=where, **cfg_kw)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*degenerate")
        sess = FederatedSession(cfg, params, loss_fn)
    p0 = sess.state.params_vec.cpu().clone()
    losses = [float(sess.train_round(None, b, 0.2)["loss"]) for b in batches]
    return losses, p0, sess.state.params_vec.cpu(), sess.sketch_decode_resolved


def sharded_agreement_phase(torch, np, dev):
    """The sharded decode (threshold top-k, one device) on the card against
    the same session on the CPU, under the agreement phase's tolerance;
    then against the card's dense threshold decode, which the reference
    pins equal to its sharded decode at atol 1e-6."""
    sharded = dict(topk_method="threshold", sketch_decode="sharded")
    l_dev, p0, p_dev, dec = _width8_session(torch, np, dev.type, **sharded)
    l_cpu, _, p_cpu, _ = _width8_session(torch, np, "cpu", **sharded)
    l_dense, _, p_dense, dec_dense = _width8_session(
        torch, np, dev.type, topk_method="threshold", sketch_decode="dense")
    moved = float(torch.linalg.vector_norm(p_cpu - p0))
    diff = float(torch.linalg.vector_norm(p_dev - p_cpu))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    dense_err = float((p_dev - p_dense).abs().max())
    dense_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_dense))
    phase("agreement_sharded", decode=dec, losses_card=l_dev,
          losses_cpu=l_cpu, loss_max_rel_err=loss_rel,
          params_diff_over_moved=diff / moved,
          vs_card_dense_params_max_abs_err=dense_err,
          vs_card_dense_loss_max_rel_err=dense_loss_rel)
    check(dec == "sharded" and dec_dense == "dense", "agreement: decodes")
    check(moved > 0, "agreement (sharded): params did not move")
    check(loss_rel <= 1e-4, f"agreement (sharded): loss rel err {loss_rel}")
    check(diff <= 1e-3 * moved,
          f"agreement (sharded): |p_card - p_cpu| = {diff} > 1e-3 * {moved}")
    check(dense_err <= 1e-6 and dense_loss_rel <= 1e-6,
          f"sharded vs dense decode on the card: params {dense_err}, "
          f"loss {dense_loss_rel}")


def replay_phase(torch, cs, dev):
    """Two sharded server updates from the same state at the main path's
    geometry and k are bit-identical (table, candidates, params): no step
    of the decode depends on float-atomic order. The aggregate sketches a
    vector with 30,000 nonzeros, so fewer than k coordinates estimate
    nonzero and the candidate buffer carries (0, 0.0) pads, and one of
    them is a large value at coordinate 0, where every pad's clipped index
    lands: the error feedback's scatter and the apply then add the pads'
    0.0 onto a real candidate."""
    from commefficient_tpu_torch.compress import get_compressor
    from commefficient_tpu_torch.parallel.mesh import SingleWorker
    from commefficient_tpu_torch.parallel.round import apply_update
    from commefficient_tpu_torch.utils.config import parse_args

    cfg = parse_args(MAIN_ARGS + SHARDED_FLAGS)
    spec = cs.CountSketch(**GEOMETRY)
    comp = get_compressor(cfg, d=spec.d, spec=spec)
    gen = torch.Generator(device=dev).manual_seed(11)
    v = torch.zeros(spec.d, device=dev)
    hot = torch.randperm(spec.d, generator=gen, device=dev)[:30_000]
    v[hot] = torch.randn(hot.numel(), generator=gen, device=dev)
    v[0] = 100.0
    agg = cs.sketch_vec(spec, v)
    mom, err = torch.zeros_like(agg), torch.zeros_like(agg)
    params = torch.randn(spec.d, generator=gen, device=dev)
    outs = []
    for _ in range(2):
        g_idx, g_val, new_m, new_e = comp.server_update_sharded(
            mom, err, agg, 0.1, group=SingleWorker(), d=spec.d)
        outs.append((g_idx, g_val, new_m, new_e,
                     apply_update(params, ("sparse", (g_idx, g_val)))))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    g_idx, g_val = outs[0][:2]
    pads = int((g_val == 0).sum())
    at_pad = bool(((g_idx == 0) & (g_val != 0)).any())
    phase("replay", bit_identical=same, candidates=g_idx.numel(),
          selected=g_idx.numel() - pads, pads=pads,
          real_candidate_at_pad_index=at_pad)
    check(same, "replay: two sharded server updates from one state differ")
    check(pads > 0 and at_pad, "replay: the pads did not meet a real "
          "candidate, so the check proved less than it should")


def sharded_main_path_phase(kern, cv_train, dataset_dir, dense_bytes):
    """``cv_train.main`` with the sharded decode for MAIN_ROUNDS rounds:
    K4's range form once a round (its explicit-index form never, with the
    dampening off), K2 never, K1 twice a round (the encode, and the
    error-feedback re-sketch, which ``sketch_sparse`` runs through K1)."""
    kern.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*degenerate")
        out = cv_train.main(MAIN_ARGS + SHARDED_FLAGS + [
            "--max_rounds", str(MAIN_ROUNDS), "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    phase("main_path_sharded", decode=out["sketch_decode"],
          D=out["grad_size"], rounds=len(hist),
          round_ms=[round(h["ms"], 3) for h in hist], losses=losses,
          val_loss=out["loss"], val_acc=out.get("accuracy"),
          param_delta_norm=out["param_delta_norm"],
          bytes_per_round=out["bytes_per_round"], launches=launches)
    check(out["sketch_decode"] == "sharded", "sharded main path: decode")
    check(out["grad_size"] == GEOMETRY["d"], "sharded main path: D")
    check(len(hist) == MAIN_ROUNDS, "sharded main path: rounds")
    check(all(math.isfinite(x) for x in losses),
          "sharded main path: loss not finite")
    check(math.isfinite(out["loss"]), "sharded main path: eval loss")
    check(out["param_delta_norm"] > 0, "sharded main path: params still")
    check(out["bytes_per_round"] == dense_bytes,
          "sharded main path: bytes per round differ from the dense path's")
    for name, want in (("estimate_at_range", MAIN_ROUNDS), ("estimate_at", 0),
                       ("estimate_median", 0),
                       ("sketch_rows", 2 * MAIN_ROUNDS)):
        check(launches[name] == want, f"sharded main path: {name} launched "
              f"{launches[name]} times, expected {want}")
    return launches


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
    return launches, out["bytes_per_round"]


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
    from commefficient_tpu_torch.ops.cuda import build, index_math
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
    report = build.ptxas_report(build.library_path().with_suffix(".log"))
    phase("ptxas", kernels=json.dumps({
        name: f"{v['registers']} regs, {v['smem_static_bytes']} B smem, "
              f"{v['spill_stores_bytes']}/{v['spill_loads_bytes']} B spills"
        for name, v in report.items()}))

    entries = kernels_phase(torch, cs, kern, build, index_math, dev)
    entries["cs_estimate_at"] = k4_phase(torch, cs, kern, dev)
    agreement_phase(torch, np, dev)
    sharded_agreement_phase(torch, np, dev)
    replay_phase(torch, cs, dev)
    # a path with no CIFAR-10 pickles: the synthetic stand-in
    dataset_dir = os.path.join(ROOT, "build", "no_dataset")
    dense, dense_bytes = main_path_phase(kern, cv_train, dataset_dir)
    sharded = sharded_main_path_phase(kern, cv_train, dataset_dir,
                                      dense_bytes)
    uncompressed_phase(kern, cv_train, dataset_dir)

    wrappers = {"cs_sketch_rows": ("sketch_rows",),
                "cs_estimate_median": ("estimate_median",),
                "median_rows": ("median_rows",),
                "cs_estimate_at": ("estimate_at", "estimate_at_range")}

    def count(launches, name):
        return sum(launches[w] for w in wrappers[name])

    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    launches=count(dense, name) + count(sharded, name),
                    launches_by_path={"dense": count(dense, name),
                                      "sharded": count(sharded, name)},
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

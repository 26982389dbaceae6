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
   before the tile kernel); K2 (every coordinate's estimate in original
   order, the unscramble fused) is also held exactly to K4's range form
   at every coordinate and timed beside it at n = D (the design before it,
   the old K2 and then the torch unscramble, is timed by
   ``ops/cuda/k2_attribution.py``); K3 unscrambled must equal K2;
   K4 (``estimate_at``) is held to its plain version exactly at three
   geometries (every coordinate of the main path, where it must also equal
   K2; 50,000 coordinates of it; a 100 MB table at 31M coordinates), both
   hash families, and timed at each; its range form
   (``estimate_at_range``, the sharded decode's) is held exactly to the
   explicit-index form at the clipped indices, at every coordinate (i) and
   at the last rank's slice of a four-way split, and timed at (i);
3. agreement: a small ResNet-9 FetchSGD session on the card against the
   same session on the CPU (the plain path that the CPU tests hold against
   the JAX package), for the dense decode and for the sharded decode with
   the threshold top-k, and the card's sharded decode against its dense
   threshold decode (atol 1e-6; both card sessions on deterministic
   cuDNN);
4. replay: two sharded server updates from one state at full width are
   bit-identical;
5. main paths: ``cv_train.main`` with the FetchSGD flags, ResNet-9 at full
   width on the synthetic CIFAR-10 stand-in, 5 rounds and one evaluation,
   with the kernels' launch counters set to 0 just before and read just
   after: first the dense decode (K1 twice a round, K2 once and no other
   estimate kernel: K2 writes the estimates in original order), then the
   sharded decode (``--topk_method threshold --sketch_decode sharded``,
   one device: K1 twice a round, K4's range form once, K2 never); then
   one ``uncompressed`` round;
6. the paper's other modes: each of ``true_topk``, ``local_topk`` (100
   clients, both client banks on the card), ``fedavg`` (two local steps)
   and ``powersgd`` (rank 4), and ``sketch`` with local momentum, first
   on the card against the CPU at width 8 (the agreement phase's
   tolerances; the card on cuDNN's deterministic algorithms, so the
   comparison does not change from run to run), then through
   ``cv_train.main`` at full width for 5 rounds, with the counters set to
   0 just before and read just after: no CountSketch kernel on the four
   modes' paths, K1 twice and K2 once a round with local momentum; each
   checks its bytes per round against the mode's formula;
7. one line of round times, printed and not checked: ``uncompressed``
   with ``--fuse_clients`` (one flattened-batch gradient) beside the
   per-client round;
8. kernels, the bf16 forms (``bf16_kernels``), at the ResNet-9 geometry
   and at GPT-2's (D = 124,444,417, r = 5, c = 5,000,000: m = 8192): K1
   with its operands rounded to bf16, its table stored in bf16, or both,
   each bit-equal to the f32 kernel on rounded input or with its table
   rounded, and within one bf16 ulp of each entry of its plain version;
   K2 on an f32 table read as bf16 and on a bf16 table, and K4 (both
   forms) on a bf16 table, exactly their plain versions; at GPT-2's
   geometry also the f32 K1 and K2, K2 in its ``<5, 0, false>``
   instantiation (no staged window, the slot tables read in place),
   which no ResNet-9 path runs. Each is timed beside its plain version,
   its bound and, for K1, one ``index_add_``;
9. the GPT-2 main path (``gpt2_main_path``): ``gpt2_train.main`` with
   BASELINE #4's flags for 5 rounds at full GPT-2-small width, with the
   counters set to 0 just before and read just after: D, exact bytes (a
   100,013,760 B table up, 497,777,668 B down), K1 10 and K2 5 launches,
   finite loss, nll and ppl, an MC accuracy in [0, 1], a sample decode,
   moved params, no envelope warning, and the round time (median of
   rounds 2-5);
10. ``gpt2_bf16_tables``: the same for 3 rounds with ``--sketch_table_dtype
    bfloat16 --sketch_dtype bfloat16``: a 50,006,880 B upload and K1's and
    K2's bf16 forms; ``sharded_bf16_tables``: the ResNet-9 sharded decode
    for 3 rounds with bf16 tables (K1 storing bf16, K4's range form on
    the f32 algebra's table);
11. ``agreement_gpt2``: three FetchSGD rounds of ``gpt2_tiny`` in float32
    on the card against the CPU, under the agreement phase's tolerances;
12. K1's segment form (``cs_sketch_segment``, the sketch-fused backward's
    kernels in ``ops/cuda/csrc/segment.cu``) held against its plain
    version (K1's f32 tolerance) into a table that already holds values,
    two launches bit-identical, at ResNet-9's geometry (its largest and
    smallest leaves, and all 26 leaves of a round, whose sum must equal
    K1 of the whole vector) and GPT-2's (``wte``, 38.6M values, a
    768-value bias, and all 150 leaves of a round, held to K1 of the
    whole vector too), timed beside its plain version, one ``index_add_``
    per row and its bound, with the scratch each geometry allocates;
13. ``fused_bwd``: ResNet-9 at full width with ``--fuse_clients true
    --sketch_fused_bwd true`` for 5 rounds (K1's segment form once a leaf
    a round), its params within ``5e-5 * max(|p|, 1)`` of the dense-grad
    fused run at seed ``FUSED_BWD_SEED`` (both on deterministic cuDNN;
    ``train/fused_bwd_probe.py`` measured the seeds), its momentum table
    within 1e-5 of max|table|, and two fused tables from one state
    bit-identical;
    ``gpt2_fused_bwd``: GPT-2 with ``--max_grad_norm none --fuse_clients
    true`` for 2 rounds with and without the fused backward, each run's
    round ms and peak ``max_memory_allocated``; both phases print each
    round's segment time and peak memory on a line of its own;
14. ``fedsim``: the ResNet-9 sketch path with bernoulli participation at
    0.3 and ``straggler@0.1`` for 5 rounds, its participation printed,
    and the width-8 card-against-CPU agreement with the same flags;
15. ``dp``: ResNet-9 ``uncompressed`` with ``--max_grad_norm 1.0
    --dp_noise_multiplier 0.5`` for 3 rounds, and the card's noise draw
    (the round's, recovered from a client's gradient) within the CPU
    statistics test's bounds;
16. ``resume``: on deterministic cuDNN, 8 ResNet-9 sketch rounds straight
    against 4, a checkpoint, a fresh session restored from it and 4 more,
    every FedState leaf bit-equal; the checkpoint's bytes and its save
    and restore ms;
17. ``batched_clients``: the batched client step (one ``torch.func.vmap``
    of the per-client function, which every per-client round above runs)
    against its plain version, the per-client loop, on one session state
    and batch: ResNet-9 at full width in sketch, sketch with local
    momentum, local_topk with the exact and the threshold top-k, fedavg,
    true_topk, powersgd, uncompressed, weight decay with the clip, the
    clip with DP noise, and fedsim masks (a dropped, a corrupted live and
    a corrupted dropped client), each held in f64 compute at the CPU
    test's tolerance (rtol 1e-5, atol 1e-6 of max) and in mixed compute
    by the norm hold against the f64 loop, and timed; GPT-2 BASELINE #4
    (clip 1.0) in f32 and in bf16 by the norm hold against the loop in
    f64, timed, with each call's peak memory;
18. ``device_data``: the main path runs on the device-resident training
    set (the default: CIFAR-10's 154 MB is under the 512 MB gate; the
    main path checks ``data=device``); here DATA_ROUNDS
    rounds of it against ``--device_data false`` on deterministic cuDNN,
    losses and every FedState leaf bit-equal, with each path's round ms,
    the sampler's host ms and the peak memory; ``rrc``: ImageNet's
    random-resized-crop on the card against numpy on one plan (1 uint8
    LSB, 1e-5 of max for float32);
19. BASELINE #3 (``femnist_local_topk``): ResNet-9 on the FEMNIST
    stand-in, local_topk with local error and momentum, 100 clients, D =
    6,598,654, 400,000 B up and 26,394,616 B down, ``data=device``;
    BASELINE #5 (``imagenet_fixup_fedavg``): FixupResNet-50 on the 64 px
    ImageNet stand-in, fedavg with two local steps, D = 25,504,026 and
    102,016,104 B each way, on the host path (the 983 MB stand-in is over
    the gate) and on the device path (``--device_data_max_mb 1024``), each
    with round ms, the sampler's host ms, peak memory and the busy share
    (device ms of a profiled round over the unprofiled round wall, the
    draw included);
    ``imagenet_fixup_sketch``: FixupResNet-50 with the FetchSGD flags at
    c = 1,071,171 (the envelope's suggestion; no warning), K1 twice and
    K2 once a round; ``cifar100``: the main path's flags on ResNet-9 with
    100 classes; and K1 and K2 at FixupResNet-50's geometry, held against
    their plain versions and timed (``geometries.fixup_resnet50``);
20. the host round pipeline: ``native``, the C++ batch assembly built by
    ``g++`` on the card's host (a failed build fails: no quiet numpy
    fallback), its build seconds, the cores and OpenMP threads, and one
    round's CIFAR prep and BASELINE #5's RRC, uint8 and float32, bit-equal
    to numpy and timed beside it; ``host_pipeline``, the main path for 5
    rounds on the host and the device path, each at ``--pipeline_depth``
    0 (the sampler's prefetch thread) and 2 (the pipelined engine, every
    round's copies staged on the card), on deterministic cuDNN: round and
    wait ms, the engine's stats, K1 twice and K2 once a round, and every
    FedState leaf after the last round bit-equal across the four runs;
    ``baseline5_host``, BASELINE #5 at the default gate (the host path)
    for 3 rounds at depth 0 and 2, round and wait ms and the busy share of
    each, beside the rounds before the host pipeline: 589.09 ms (host)
    and 179.81 ms (device);
21. the decode options, sparse aggregation, overlap and FSDP, each run
    ResNet-9 at full width for 3 rounds through ``cv_train.main`` on
    deterministic cuDNN, the counters set to 0 just before each run and
    read just after, its state read from its end-of-training checkpoint
    (the CIFAR-10 stand-in drawn once for all of them): ``num_blocks``,
    the main path with ``--num_blocks 4`` against ``--num_blocks 1``,
    every leaf bit-equal, K4's range form 4 times a round and K2 never
    (K2 once at 1), each run's round ms and peak memory, and
    ``estimate_all`` at num_blocks 4 held exactly to K2 and to the range
    form's plain version slice by slice, and timed beside K2;
    ``approx``, ``--topk_method approx`` bit-equal to exact;
    ``sparse_aggregate``, local_topk and true_topk (threshold) and sketch
    (sharded decode) with ``--aggregate sparse`` against ``dense``, the
    resolved aggregation and the one-device warning printed, every leaf
    within the CPU twins' 1e-5 (bit-equality printed), and local_topk's
    ``sparse_allreduce`` at its capacity timed alone; ``overlap``, the fused backward with
    ``--overlap_collectives layerwise`` (the segment form once a leaf a
    round) and its four group tables of one state, summed, within the
    segment form's ``1e-5 * max|table|`` of the monolithic table;
    ``fsdp``, sketch, true_topk and uncompressed with ``--fsdp true
    --topk_method threshold`` against the replicated round, every leaf
    within 2e-5;
22. ``telemetry`` (``--telemetry_level``): the main path's flags at levels
    0, 1 and 2 for 3 rounds each on deterministic cuDNN, every leaf of the
    final state bit-equal across the levels, each level's launches exactly
    (level 0: the main path's K1 2 and K2 1 a round; level 1 adds K3
    twice a round, the AMS estimates of the aggregate and the error
    table; level 2 adds K1 once and K4's index form once, the fidelity's
    round trip), round ms and peak memory; ``diag/*`` finite, the
    sentinel 0, the last ``diag/update_norm`` equal to the saved params'
    move (rtol 1e-3), K3 exactly its plain network on the run's tables,
    the fidelity's K1 + K4 route exactly its plain route, the ledger's
    exactness by the phase's own arithmetic, strict JSON; ``--chaos
    nan_client@2`` raising ``DivergenceError`` at round 2 with
    ``flight_2.json``; GPT-2 BASELINE #4 at levels 0 and 1 for 2 rounds;
    the device ms of one call of the diagnostics at both geometries;
23. ``spans`` (the host spans, the critical path, the reports and the
    ``--profile_rounds`` window): the main path at level 1 for 8 rounds at
    ``--pipeline_depth`` 0 and 2 with ``--profile_rounds 4-5``, and with
    ``--perf_audit false --run_report false``: every leaf bit-equal
    across the runs of one depth, one ``round_dispatch`` span a round,
    the prefetch spans on the ``round-prefetch`` lane at depth 2, each
    round's stage times summing to its wall, ``run_report.json`` over
    every round with fractions summing to 1, ``perf_report.json``'s FLOPs
    and peak memory with no collective, ``xla/exposed_collective_ms`` 0
    every round, the window's trace holding K1 twice a window round, and
    K1, K2, K3 at 2, 1, 2 a round; GPT-2 BASELINE #4 at level 1 for 3
    rounds; the stage p50s, the critical stage, round 0's FLOPs and peak;
    the host µs of one span and of one round's ``trace/*`` scalars;
24. ``control`` (the control plane, ``control/``): the main path at level
    1 for 8 rounds on deterministic cuDNN with ``--control_policy fixed
    --ladder "k=50000,25000;num_cols=500000,250000" --control_schedule
    "0-2=0,3-5=1,6-=0"`` against its control-free twin: the rung
    sequence, 2 switches, the ledger's per-rung rounds (5 and 3) and
    exact bytes, K1 and K2 each 4 launches more than the twin (a
    ``num_cols`` switch decodes each of the two tables through K2 and
    re-sketches it through K1), each migration on the switch's tensors
    held against its plain version (K2 exactly, K1 to ``1e-5 *
    max|table|``), its ms, and the host µs of ``on_round_start``; the
    same at ``--pipeline_depth 2`` (bit-equal, a quiesce a switch) and
    checkpointed at round 4 and resumed (the rungs, the controller's blob
    and every leaf bit-equal); ``budget_pacing`` stopping with
    ``BudgetExhaustedError`` at round 5 (the ledger, the flight dump's
    controller block); ``ef_feedback`` (finite, launches by its
    switches);
25. ``resilience`` (self-healing, ``resilience/``): the main path at level
    1 with bernoulli participation at 0.25 for 8 rounds on deterministic
    cuDNN: a ``nan_client@1:rounds=5-5`` run under ``--recover_policy
    retry --snapshot_every 4`` bit-equal to its chaos-free twin (every
    leaf and every deduped ``train/loss``, ``diag/*``, ``fedsim/*`` and
    ``comm/*`` scalar), one rollback to round 4, the flight dumps, and K1,
    K2 and K3 at the twin's launches plus the 4 replayed rounds'; the same
    at ``--pipeline_depth 2`` (one restart); ``demote`` on the control
    phase's ladder, ending on rung 1 with its migration held against its
    plain version and no plan built from the recovery on;
    ``skip_clients`` with the ledger's live-byte invariant; ``preempt@4``
    exiting 75 with a forced checkpoint, resumed bit-equal, and a
    ``cv_train`` subprocess exiting 75; C.1: a 10-rung ``num_cols``
    ladder prewarmed (no launch), a switch to each rung with no plan
    built, and a fresh process's first switch (``chip_smoke.py
    --fresh-switch``) within 2x of its steady switches; the snapshot's
    capture ms and bytes, the restore's and the recovery's ms;
26. ``clientstore`` (host-resident client state, ``clientstore/``): the
    main path with ``--local_momentum 0.9`` (a velocity bank) at level 1
    for 8 rounds on deterministic cuDNN on the host data path: at 16
    clients the ``device``, ``host``, ``mmap`` and cached (4 rows) stores
    and ``host``, ``mmap`` and ``device`` at ``--pipeline_depth 2``, every
    FedState leaf, the bank and every loss bit-equal to the device bank's
    run, K1 16, K2 8 and K3 16 launches a run, the bytes per round of
    ``sketch_local_momentum``, the stale cohorts gathered again at depth
    2; a ``host`` run checkpointed at round 4 and resumed, bit-equal; at
    10,000 clients (a 262.9 GB bank) the device bank's allocation raising
    ``torch.OutOfMemoryError`` and ``mmap`` training 8 rounds, its file's
    allocated bytes (``st_blocks``, or the free disk's drop where the file
    system reports no holes) within the rows written; the round ms of each
    store at both depths; C.4: under the sharded decode and at
    ``--num_blocks 4`` a 4-rung ``num_cols`` ladder prewarmed and every
    rung visited with no plan built after the prewarm;
27. ``asyncfed`` (buffered-asynchronous federation, ``asyncfed/``): the
    main path at level 1 for 8 updates on deterministic cuDNN and the
    host data path: the anchor (``--async_buffer 8 --async_concurrency 1
    --staleness_exponent 0``) bit-equal to the synchronous run (every
    leaf and loss), K1 16, K2 8 and K3 16 in both, the ledger's bytes
    equal and ``perf_report.json``'s ``engine: "async"`` with its block;
    overlap (K 4, C 2, exponent 0.5, poisson 0.9): ``async/staleness_mean``
    and ``async/buffer_fill`` as ``AsyncSchedule`` scripts them, K1 2, K2
    1 and K3 2 an update whatever the cohorts launched, the window's
    largest bytes exactly the schedule's cohorts times a cohort's rows,
    and under the sharded decode K4's range form once an update and K2
    never; both with ``--async_double_buffer`` bit-equal to their twins;
    the overlap run with every live slot of cohort 3 corrupted under
    ``--recover_policy retry --snapshot_every 4`` bit-equal to it (the
    window rides the vault), and two resumes from its round-4 checkpoint
    bit-equal to each other; ``--control_policy staleness_aware`` on a
    4-rung ``num_cols`` ladder at C 3 switching rungs and retuning (K, C)
    with no plan built after the prewarm; the median ms an update of each
    run, the prefetch and stall ms, the window, the peak memory and the
    snapshot's ms printed.

Since the deferred drain (port PR 11) a history row's ``ms`` is the
round's share of the wall clock, dispatch to next dispatch (the last
round's to the end of the drain), and ``data_ms`` the wait for its
inputs; the phases above that print them print that.

The last lines are the card (``nvidia-smi``), one JSON object listing every
kernel and every bf16 form (``launches`` summed over every path,
``launches_by_path`` beside it, ``geometries`` with the other geometry's
numbers), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
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
SEGMENT_SOURCE = "commefficient_tpu_torch/ops/cuda/csrc/segment.cu"
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
D_FULL = GEOMETRY["d"]
# the paper's other modes at full width: path -> (flags over MAIN_ARGS,
# upload floats, download floats per client per round)
MODE_PATHS = {
    "true_topk": (["--mode", "true_topk"], D_FULL, D_FULL),
    "local_topk": (["--mode", "local_topk", "--error_type", "local",
                    "--local_momentum", "0.9", "--num_clients", "100"],
                   2 * 50_000, D_FULL),
    "fedavg": (["--mode", "fedavg", "--error_type", "none",
                "--num_local_iters", "2"], D_FULL, D_FULL),
    # the [2564, 2564] matricization: 4 * (2564 + 2564) floats down
    "powersgd": (["--mode", "powersgd", "--powersgd_rank", "4"], D_FULL,
                 4 * (2564 + 2564)),
}
# the same modes at width 8: path -> lr (their settings are
# agreement_probe.MODES). powersgd runs at lr 0.05: at 0.2 its rank-4
# power iteration on the near-rank-1 width-8 gradients is ill-conditioned
# (on the CPU alone a 1e-7 relative change of the initial params moves
# its 3-round params by ~1e-3 of their movement for some seeds, the
# tolerance itself; python -m commefficient_tpu_torch.train.
# agreement_probe measures it)
W8_LRS = {"true_topk": 0.2, "local_topk": 0.2, "fedavg": 0.2,
          "powersgd": 0.05, "sketch_local_momentum": 0.2}
# GPT-2 small on PersonaChat (BASELINE config #4), the [5, 5,000,688] table
GPT2_GEOMETRY = dict(d=124_444_417, c=5_000_000, r=5, band=16, seed=42)
GPT2_ARGS = ["--mode", "sketch", "--k", "50000", "--num_rows", "5",
             "--num_cols", "5000000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--compute_dtype", "bfloat16",
             "--num_workers", "8", "--num_devices", "1"]
GPT2_BYTES = {"upload_floats": 25_003_440, "download_floats": 124_444_417,
              "upload_bytes": 100_013_760, "download_bytes": 497_777_668}
BF16_ROUNDS = 3
AGREEMENT_GPT2 = dict(seed=3, lr=0.2)  # agreement_probe --modes gpt2_tiny
# the kernels' type variants: JSON entry -> [(wrapper, form)] it counts
FORMS = {
    "cs_sketch_rows": [("sketch_rows", "f32")],
    "cs_sketch_rows[bf16_operand]": [("sketch_rows", "bf16_operand")],
    "cs_sketch_rows[bf16_table]": [("sketch_rows", "bf16_table")],
    "cs_sketch_rows[bf16_operand_bf16_table]": [
        ("sketch_rows", "bf16_operand_bf16_table")],
    "cs_estimate_median": [("estimate_median", "f32")],
    "cs_estimate_median[f32_table_bf16_operand]": [
        ("estimate_median", "f32_table_bf16_operand")],
    "cs_estimate_median[bf16_table]": [("estimate_median", "bf16_table")],
    "median_rows": [("median_rows", "f32")],
    "cs_estimate_at": [("estimate_at", "f32"), ("estimate_at_range", "f32")],
    "cs_estimate_at[bf16_table]": [("estimate_at", "bf16_table"),
                                   ("estimate_at_range", "bf16_table")],
    "cs_sketch_segment": [("sketch_segment", "f32")],
}
# the geometry of each bf16 form's main path (its top-level numbers)
FORM_MAIN_GEOMETRY = {
    "cs_sketch_rows[bf16_operand]": "gpt2",
    "cs_sketch_rows[bf16_table]": "resnet9",
    "cs_sketch_rows[bf16_operand_bf16_table]": "gpt2",
    "cs_estimate_median[f32_table_bf16_operand]": "gpt2",
    "cs_estimate_median[bf16_table]": "gpt2",
    "cs_estimate_at[bf16_table]": "resnet9",
}


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
        # K2, on the kernel's own table (the main path's input): [d] in
        # original order, exactly the plain version and K4's range form
        e_k = kern.estimate_median(spec, t_k)
        e_p = kern.estimate_median_torch(spec, t_k)
        e_r = kern.estimate_at_range(spec, t_k, 0, spec.d)
        torch.cuda.synchronize()
        check(e_k.shape == (spec.d,), f"K2 {family}: shape {e_k.shape}")
        err2 = float((e_k - e_p).abs().max())
        check(torch.equal(e_k, e_p),
              f"K2 {family}: max err {err2} (expected exact)")
        check(torch.equal(e_k, e_r), f"K2 {family}: differs from K4's range "
              "form at every coordinate")
        # K3 on the [r, d_eff] stack of per-row estimates (scrambled order)
        maps = kern._plain_maps(spec, str(v_s.device))
        stack = torch.stack([t_k[row][cols] * sign
                             for row, (cols, sign) in enumerate(maps)])
        m_k = kern.median_rows(stack)
        m_p = kern.median_rows_torch(stack)
        torch.cuda.synchronize()
        err3 = float((m_k - m_p).abs().max())
        check(err3 == 0.0, f"K3 {family}: max err {err3} (expected exact)")
        check(torch.equal(cs._unscramble(spec, m_k), e_k),
              f"K3 {family}: the median of the per-row estimates, "
              "unscrambled, differs from K2")
        phase("kernels", family=family, k1_max_abs_err=err1, k1_tol=tol1,
              k1_bit_identical_rerun=True, k2_max_abs_err=err2,
              k2_equals_k4_range_form=True, k3_max_abs_err=err3,
              hash_bits="exact")
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
                         rows, r, 0, 0, 0, 0, kern._stream())
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
        # K2's function reads the table and the block permutation once and
        # writes the [d] estimates; the packed sign bits and the slot tables
        # are this design's lookup data (the hashes they replace need no
        # bytes), so they are reported beside the bound, not in it
        plan2 = kern._k2_plan(spec, str(dev))
        d = spec.d
        b2, by2 = bound(4 * r * c + 4 * plan2["perm"].numel() + 4 * d,
                        r * d + r * (r - 1) * d)
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
            bound_ms=b2, bound_by=by2, library_ms=None,
            k4_range_form_ms=cuda_ms(torch, lambda: kern.estimate_at_range(
                spec, t_k, 0, d)),
            staged_rows=list(plan2["staged"]),
            slot_tables_in_smem=plan2["slot_smem"],
            dynamic_smem_bytes=plan2["smem_bytes"],
            sign_bits_bytes=4 * plan2["signs"].numel(),
            slot_table_bytes=4 * plan2["slots"].numel())
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
                      "gather_kernel_ms", "tile_strides",
                      "k4_range_form_ms") if k in e})
        del flat_cols, flat_src, flat_table, stack
    return entries


def agreement_phase(torch, dev, name="agreement", lr=0.2,
                    deterministic=False, session=None, **cfg_kw):
    """Three FetchSGD rounds of a width-8 ResNet-9 in float32 on the card
    and on the CPU from the same params and batches (``cfg_kw`` over the
    sketch session's settings: another mode, local momentum). The CPU path
    is the one the CPU tests hold against the JAX package; the card sums
    buckets, convolutions and products in another order, and a near-tie at
    the k-th place may pick another coordinate, so params agree within
    1e-3 of how far they moved and losses within rtol 1e-4.
    ``deterministic`` runs the card's cuDNN on deterministic algorithms
    (the default ones may sum a weight gradient with atomics, so two runs
    of one session on the card differ in the last bits, and a rare
    near-tie then goes one way or the other from run to run).
    ``session`` is another session of ``agreement_probe`` (its
    ``gpt2_tiny_session``)."""
    from commefficient_tpu_torch.train.agreement_probe import width8_session

    session = session or width8_session
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or prev
    try:
        l_dev, p0, p_dev, _ = session(dev.type, lr=lr, **cfg_kw)
    finally:
        torch.backends.cudnn.deterministic = prev
    l_cpu, _, p_cpu, _ = session("cpu", lr=lr, **cfg_kw)
    moved = float(torch.linalg.vector_norm(p_cpu - p0))
    diff = float(torch.linalg.vector_norm(p_dev - p_cpu))
    # a round where every client drops (fedsim) has loss 0 on both
    loss_rel = max(abs(a - b) / abs(b) if b else abs(a - b)
                   for a, b in zip(l_dev, l_cpu))
    phase(name, D=p0.numel(), lr=lr, losses_card=l_dev, losses_cpu=l_cpu,
          loss_max_rel_err=loss_rel, params_diff_over_moved=diff / moved)
    check(moved > 0, f"{name}: params did not move")
    check(loss_rel <= 1e-4, f"{name}: loss rel err {loss_rel} > 1e-4")
    check(diff <= 1e-3 * moved,
          f"{name}: |p_card - p_cpu| = {diff} > 1e-3 * {moved}")


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
                full = kern.estimate_median(spec, table)
                check(torch.equal(got, full), f"K4 {family}: estimate_at of "
                      "every coordinate differs from K2")
                fields["equals_k2"] = True
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


def sharded_agreement_phase(torch, dev):
    """The sharded decode (threshold top-k, one device) on the card against
    the same session on the CPU, under the agreement phase's tolerance;
    then against the card's dense threshold decode, which the reference
    pins equal to its sharded decode at atol 1e-6. The card's sessions
    run on deterministic cuDNN: the two card runs must compute the same
    gradients, so that only their decodes differ (default cuDNN may sum
    the batched clients' weight gradients with atomics, and a near-tie of
    the threshold then goes one way in one run and the other way in the
    next)."""
    from commefficient_tpu_torch.train.agreement_probe import width8_session

    sharded = dict(topk_method="threshold", sketch_decode="sharded")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        l_dev, p0, p_dev, dec = width8_session(dev.type, **sharded)
        l_dense, _, p_dense, dec_dense = width8_session(
            dev.type, topk_method="threshold", sketch_decode="dense")
    finally:
        torch.backends.cudnn.deterministic = prev
    l_cpu, _, p_cpu, _ = width8_session("cpu", **sharded)
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
        g_idx, g_val, new_m, new_e, _ = comp.server_update_sharded(
            mom, err, None, agg, 0.1, 0, group=SingleWorker(), d=spec.d)
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
    return kern.form_counts()


def main_path_phase(kern, cv_train, dataset_dir):
    kern.reset_launch_counts()
    out = cv_train.main(MAIN_ARGS + ["--max_rounds", str(MAIN_ROUNDS),
                                     "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    phase("main_path", D=out["grad_size"], data=out["data_path"],
          upload_bytes_per_client=out["bytes_per_round"]["upload_bytes"],
          download_bytes_per_client=out["bytes_per_round"]["download_bytes"],
          rounds=len(hist), round_ms=[round(h["ms"], 3) for h in hist],
          losses=losses, val_loss=out["loss"],
          val_acc=out.get("accuracy"), param_delta_norm=out[
              "param_delta_norm"], launches=launches)
    check(out["grad_size"] == GEOMETRY["d"], "main path: unexpected D")
    check(out["data_path"] == "device", f"main path: data="
          f"{out['data_path']}, expected the device-resident training set")
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
    for name in ("estimate_at", "estimate_at_range", "median_rows"):
        check(launches[name] == 0, f"main path: {name} launched "
              f"{launches[name]} times, expected 0 (K2 does its work)")
    return kern.form_counts(), out["bytes_per_round"]


def uncompressed_args():
    """MAIN_ARGS for ``uncompressed``: the mode swapped, the sketch's
    flags dropped."""
    args = list(MAIN_ARGS)
    args[args.index("sketch")] = "uncompressed"
    for flag in ("--error_type", "--k", "--num_rows", "--num_cols"):
        i = args.index(flag)
        del args[i:i + 2]
    return args


def uncompressed_phase(kern, cv_train, dataset_dir):
    args = uncompressed_args()
    kern.reset_launch_counts()
    out = cv_train.main(args + ["--max_rounds", "1", "--dataset_dir",
                                dataset_dir])
    loss = out["history"][0]["loss"]
    phase("uncompressed", loss=loss, round_ms=out["history"][0]["ms"],
          launches=kern.launch_counts())
    check(math.isfinite(loss) and out["param_delta_norm"] > 0,
          "uncompressed round: loss not finite or params did not move")


def mode_path_phase(kern, cv_train, dataset_dir, name, flags, up, down):
    """``cv_train.main`` for MAIN_ROUNDS full-width rounds of one of the
    other modes (``flags`` over MAIN_ARGS), the counters set to 0 just
    before and read just after: loss finite, params moved, bytes per
    client per round ``up`` and ``down`` floats, and no CountSketch kernel
    launched (none is on these paths)."""
    kern.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*dampening=AUTO")
        out = cv_train.main(MAIN_ARGS + flags + [
            "--max_rounds", str(MAIN_ROUNDS), "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    bpr = out["bytes_per_round"]
    phase(f"mode_{name}", D=out["grad_size"], rounds=len(hist),
          round_ms=[round(h["ms"], 3) for h in hist], losses=losses,
          val_loss=out["loss"], param_delta_norm=out["param_delta_norm"],
          bytes_per_round=bpr, launches=launches)
    check(out["grad_size"] == D_FULL, f"{name}: D")
    check(len(hist) == MAIN_ROUNDS, f"{name}: rounds")
    check(all(math.isfinite(x) for x in losses), f"{name}: loss not finite")
    check(math.isfinite(out["loss"]), f"{name}: eval loss not finite")
    check(out["param_delta_norm"] > 0, f"{name}: params did not move")
    check(bpr == {"upload_floats": up, "download_floats": down,
                  "upload_bytes": 4 * up, "download_bytes": 4 * down},
          f"{name}: bytes per round {bpr}, expected {up} up, {down} down")
    check(not any(launches.values()), f"{name}: a CountSketch kernel "
          f"launched on a path that has none: {launches}")
    return kern.form_counts()


def sketch_local_momentum_phase(kern, cv_train, dataset_dir, dense_bytes):
    """The dense FetchSGD path with local momentum (a [16, D] velocity
    bank on the card), MAIN_ROUNDS rounds: K1 twice and K2 once a round,
    as on the main path, and its bytes per round."""
    kern.reset_launch_counts()
    out = cv_train.main(MAIN_ARGS + ["--local_momentum", "0.9",
                                     "--max_rounds", str(MAIN_ROUNDS),
                                     "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    phase("sketch_local_momentum", D=out["grad_size"], rounds=len(hist),
          round_ms=[round(h["ms"], 3) for h in hist], losses=losses,
          val_loss=out["loss"], param_delta_norm=out["param_delta_norm"],
          launches=launches)
    check(len(hist) == MAIN_ROUNDS, "sketch + local momentum: rounds")
    check(all(math.isfinite(x) for x in losses) and math.isfinite(
        out["loss"]), "sketch + local momentum: loss not finite")
    check(out["param_delta_norm"] > 0, "sketch + local momentum: params")
    check(out["bytes_per_round"] == dense_bytes,
          "sketch + local momentum: bytes per round")
    for name, want in (("sketch_rows", 2 * MAIN_ROUNDS),
                       ("estimate_median", MAIN_ROUNDS), ("estimate_at", 0),
                       ("estimate_at_range", 0), ("median_rows", 0)):
        check(launches[name] == want, f"sketch + local momentum: {name} "
              f"launched {launches[name]} times, expected {want}")
    return kern.form_counts()


def fused_timing_phase(cv_train, dataset_dir, rounds: int = 5):
    """Round times of full-width ``uncompressed`` (virtual momentum 0.9,
    8 clients of 64 images) with the per-client loop and with
    ``--fuse_clients``, one run each: printed, not checked (the CPU tests
    hold the two equal)."""
    args = uncompressed_args()
    ms = {}
    for name, extra in (("per_client", []),
                        ("fused", ["--fuse_clients", "true"])):
        out = cv_train.main(args + extra + ["--max_rounds", str(rounds),
                                            "--dataset_dir", dataset_dir])
        ms[name] = [h["ms"] for h in out["history"]]
        check(all(math.isfinite(h["loss"]) for h in out["history"]),
              f"fused timing ({name}): loss not finite")
    phase("fused_timing", per_client_round_ms=[round(t, 3) for t in
                                               ms["per_client"]],
          fused_round_ms=[round(t, 3) for t in ms["fused"]],
          per_client_median_after_first=statistics.median(
              ms["per_client"][1:]),
          fused_median_after_first=statistics.median(ms["fused"][1:]))



def bf16_kernels_phase(torch, cs, kern, dev):
    """The bf16 forms of K1, K2 and K4, and the f32 K1 and K2 at GPT-2's
    geometry (K2 there in ``<5, 0, false>``): each held against its plain
    version and timed (CUDA events; the plain versions at GPT-2's
    geometry with 5 samples of 2 calls). Returns ``{entry: {geometry:
    numbers}}`` for the ``kernels`` line."""
    BF, F32 = torch.bfloat16, torch.float32
    k1_forms = {"bf16_operand": (BF, F32), "bf16_table": (F32, BF),
                "bf16_operand_bf16_table": (BF, BF)}
    k2_forms = {"f32_table_bf16_operand": (F32, BF), "bf16_table": (BF, F32)}
    out = {}

    def put(entry, geo, **row):
        out.setdefault(entry, {})[geo] = row
        phase("timing", kernel=entry, geometry=geo, **row)

    for geo_name, geo in (("resnet9", GEOMETRY), ("gpt2", GPT2_GEOMETRY)):
        big = geo_name == "gpt2"
        light = dict(samples=5, calls=2) if big else {}
        spec = cs.CountSketch(**geo)
        r, c, d, d_eff = spec.r, spec.c_actual, spec.d, spec.d_eff
        gen = torch.Generator(device=dev).manual_seed(0)
        v_s = cs._scramble(spec, torch.randn(d, generator=gen, device=dev))
        rows, ptr, off, tile = kern._kernel_geometry(spec, str(dev))[:4]
        csr = 4 * (ptr.numel() + off.numel())
        maps = kern._plain_maps(spec, str(dev))
        flat_cols = torch.cat([row * c + cols for row, (cols, _)
                               in enumerate(maps)])
        flat_src = torch.cat([v_s * sign for _, sign in maps])
        flat_table = torch.zeros(r * c, device=dev)
        lib1 = cuda_ms(torch, lambda: flat_table.index_add_(0, flat_cols,
                                                            flat_src),
                       **light)
        del flat_cols, flat_src, flat_table
        plan = kern._k2_plan(spec, str(dev))
        perm = 4 * plan["perm"].numel()
        t32 = kern.sketch_rows(spec, v_s)
        if big:  # the f32 forms at GPT-2's geometry
            want = kern.sketch_rows_torch(spec, v_s)
            torch.cuda.synchronize()
            err = float((t32 - want).abs().max())
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            check(err <= tol, f"K1 at GPT-2: max err {err} > {tol}")
            del want
            b, by = bound(4 * d_eff + 4 * r * c + csr, r * d_eff)
            put("cs_sketch_rows", "gpt2", max_abs_err=err,
                ms=cuda_ms(torch, lambda: kern.sketch_rows(spec, v_s)),
                plain_ms=cuda_ms(torch, lambda: kern.sketch_rows_torch(
                    spec, v_s), **light),
                bound_ms=b, bound_by=by, library_ms=lib1, tile_strides=tile)
            check(plan["staged"] == () and not plan["slot_smem"],
                  "K2 at GPT-2's geometry: expected no staged window and "
                  "the slot tables in place (<5, 0, false>)")
            e_k = kern.estimate_median(spec, t32)
            e_p = kern.estimate_median_torch(spec, t32)
            torch.cuda.synchronize()
            check(torch.equal(e_k, e_p), "K2 <5, 0, false> at GPT-2: "
                  f"max err {float((e_k - e_p).abs().max())}")
            del e_k, e_p
            b, by = bound(4 * r * c + perm + 4 * d, r * d + r * (r - 1) * d)
            put("cs_estimate_median", "gpt2", max_abs_err=0.0,
                ms=cuda_ms(torch, lambda: kern.estimate_median(spec, t32)),
                plain_ms=cuda_ms(torch, lambda: kern.estimate_median_torch(
                    spec, t32), **light),
                bound_ms=b, bound_by=by, library_ms=None,
                instantiation="<5,0,false>",
                dynamic_smem_bytes=plan["smem_bytes"])
        for form, (operand, tdt) in k1_forms.items():
            got = kern.sketch_rows(spec, v_s, operand, tdt)
            x = v_s.to(BF).float() if operand == BF else v_s
            check(torch.equal(got, kern.sketch_rows(spec, x).to(tdt)),
                  f"K1 {form} {geo_name}: differs from the f32 kernel on "
                  "rounded input or with its table rounded")
            want = kern.sketch_rows_torch(spec, v_s, operand, tdt).float()
            diff = (got.float() - want).abs()
            err = float(diff.max())
            if tdt == BF:
                ok = bool((diff <= 2.0**-7 * want.abs()
                           + 1e-6 * float(want.abs().max())).all())
            else:
                ok = err <= 1e-5 * max(1.0, float(want.abs().max()))
            check(ok, f"K1 {form} {geo_name}: max err {err} against the "
                  "plain version")
            del got, want, diff, x
            b, by = bound(4 * d_eff + tdt.itemsize * r * c + csr, r * d_eff)
            put(f"cs_sketch_rows[{form}]", geo_name, max_abs_err=err,
                ms=cuda_ms(torch, lambda: kern.sketch_rows(spec, v_s,
                                                           operand, tdt)),
                plain_ms=cuda_ms(torch, lambda: kern.sketch_rows_torch(
                    spec, v_s, operand, tdt), **light),
                bound_ms=b, bound_by=by, library_ms=lib1,
                bit_equal_to_f32_kernel=True)
        for form, (tdt, operand) in k2_forms.items():
            t = t32.to(tdt)
            got = kern.estimate_median(spec, t, operand)
            want = kern.estimate_median_torch(spec, t, operand)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K2 {form} {geo_name}: max err "
                  f"{float((got - want).abs().max())} (expected exact)")
            check(torch.equal(got, kern.estimate_median(
                spec, t32.to(BF).float())), f"K2 {form} {geo_name}: "
                "differs from the f32 form on the rounded table")
            del got, want
            b, by = bound(tdt.itemsize * r * c + perm + 4 * d,
                          r * d + r * (r - 1) * d)
            put(f"cs_estimate_median[{form}]", geo_name, max_abs_err=0.0,
                ms=cuda_ms(torch, lambda: kern.estimate_median(spec, t,
                                                               operand)),
                plain_ms=cuda_ms(torch, lambda: kern.estimate_median_torch(
                    spec, t, operand), **light),
                bound_ms=b, bound_by=by, library_ms=None,
                staged_rows=list(kern._k2_plan(spec, str(dev),
                                               tdt.itemsize)["staged"]))
        if not big:  # K4 on a bf16 table, both forms, every coordinate
            t = t32.to(BF)
            idx = torch.arange(d, device=dev)
            a_k = kern.estimate_at(spec, t, idx)
            r_k = kern.estimate_at_range(spec, t, 0, d)
            want = kern.estimate_at_torch(spec, t, idx)
            torch.cuda.synchronize()
            check(torch.equal(a_k, want) and torch.equal(r_k, want),
                  "K4 on a bf16 table: differs from the plain version")
            check(torch.equal(r_k, kern.estimate_at_range(spec, t.float(), 0,
                                                          d)),
                  "K4 on a bf16 table: differs from the widened f32 table")
            rplan = kern._range_plan(spec, 0, d, str(dev), 2)
            b, by = bound(4 * d + 2 * r * c + perm
                          + 4 * rplan["blocks"].numel(),
                          r * d + r * (r - 1) * d)
            put("cs_estimate_at[bf16_table]", "resnet9", max_abs_err=0.0,
                ms=cuda_ms(torch, lambda: kern.estimate_at_range(spec, t, 0,
                                                                 d)),
                plain_ms=cuda_ms(torch, lambda: kern.estimate_at_range_torch(
                    spec, t, 0, d)),
                bound_ms=b, bound_by=by, library_ms=None,
                form="range, n = D",
                arbitrary_index_ms=cuda_ms(torch, lambda: kern.estimate_at(
                    spec, t, idx)),
                staged_rows=list(rplan["staged"]))
            del a_k, r_k, want, idx
        del v_s, t32, maps
        kern._plain_maps.cache_clear()  # ~7.5 GB at GPT-2's geometry
        torch.cuda.empty_cache()
    return out


def gpt2_path_phase(kern, gpt2_train, dataset_dir, name, flags, rounds,
                    bytes_per_round, want_forms):
    """``gpt2_train.main`` with BASELINE #4's flags (``flags`` over them)
    for ``rounds`` rounds at full GPT-2-small width, the counters set to 0
    just before and read just after: D, the exact bytes per client, the
    kernels' launches by form (``want_forms``), finite losses, nll and
    ppl, an MC accuracy in [0, 1], a sample decode, moved params and no
    envelope warning; prints the round time (median after the first)."""
    kern.reset_launch_counts()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = gpt2_train.main(GPT2_ARGS + flags + [
            "--max_rounds", str(rounds), "--dataset_dir", dataset_dir])
    forms = kern.form_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    envelope = [str(w.message) for w in rec if "envelope" in str(w.message)]
    prompt, gen = out["samples"][-1]
    ms = [h["ms"] for h in hist]
    phase(name, D=out["grad_size"], bytes_per_round=out["bytes_per_round"],
          rounds=len(hist), round_ms=[round(t, 3) for t in ms],
          round_ms_median_after_first=statistics.median(ms[1:]),
          losses=losses, val_nll=out["nll"], val_ppl=out["ppl"],
          val_mc_acc=out["mc_accuracy"],
          param_delta_norm=out["param_delta_norm"],
          sample_generated=gen.tolist(), launches=forms,
          envelope_warnings=len(envelope))
    check(out["grad_size"] == GPT2_GEOMETRY["d"], f"{name}: D")
    check(len(hist) == rounds, f"{name}: rounds")
    check(all(math.isfinite(x) for x in losses), f"{name}: loss not finite")
    check(math.isfinite(out["nll"]) and math.isfinite(out["ppl"]),
          f"{name}: nll or ppl not finite")
    check(0.0 <= out["mc_accuracy"] <= 1.0, f"{name}: MC accuracy")
    check(out["param_delta_norm"] > 0, f"{name}: params did not move")
    check(len(prompt) > 0 and len(gen) > 0, f"{name}: no sample decode")
    check(out["bytes_per_round"] == bytes_per_round,
          f"{name}: bytes per round {out['bytes_per_round']}")
    check(not envelope, f"{name}: envelope warning {envelope}")
    got = {w: f for w, f in forms.items() if f}
    check(got == want_forms, f"{name}: launches {got}, expected {want_forms}")
    return forms


def sharded_bf16_phase(kern, cv_train, dataset_dir):
    """The ResNet-9 sharded decode (one card) for BF16_ROUNDS rounds with
    bf16 tables: K1 storing bf16 twice a round (the encode and the error
    feedback's slice sketch, whose group sum travels in bf16), K4's range
    form once, on the f32 table the server algebra works on."""
    kern.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*degenerate")
        out = cv_train.main(MAIN_ARGS + SHARDED_FLAGS + [
            "--sketch_table_dtype", "bfloat16", "--max_rounds",
            str(BF16_ROUNDS), "--dataset_dir", dataset_dir])
    forms = kern.form_counts()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    bpr = out["bytes_per_round"]
    phase("sharded_bf16_tables", decode=out["sketch_decode"],
          D=out["grad_size"], rounds=len(hist),
          round_ms=[round(h["ms"], 3) for h in hist], losses=losses,
          val_loss=out["loss"], param_delta_norm=out["param_delta_norm"],
          bytes_per_round=bpr, launches=forms)
    check(out["sketch_decode"] == "sharded", "sharded bf16: decode")
    check(len(hist) == BF16_ROUNDS, "sharded bf16: rounds")
    check(all(math.isfinite(x) for x in losses), "sharded bf16: loss")
    check(out["param_delta_norm"] > 0, "sharded bf16: params did not move")
    check(bpr["upload_bytes"] == 2 * 5 * 505_440
          and bpr["download_bytes"] == 4 * D_FULL,
          f"sharded bf16: bytes per round {bpr}")
    got = {w: f for w, f in forms.items() if f}
    want = {"sketch_rows": {"bf16_table": 2 * BF16_ROUNDS},
            "estimate_at_range": {"f32": BF16_ROUNDS}}
    check(got == want, f"sharded bf16: launches {got}, expected {want}")
    return forms


# -- the fused backward, fedsim, DP, checkpoint/resume ----------------------


FUSED_FLAGS = ["--fuse_clients", "true"]
SEGMENT_REPLACES = ("commefficient_tpu/ops/countsketch.py:898 "
                    "(sketch_segment, an XLA scatter through sketch_sparse; "
                    "no Pallas kernel)")
FEDSIM_FLAGS = ["--availability", "bernoulli", "--dropout_prob", "0.3",
                "--chaos", "straggler@0.1"]
DP_FLAGS = ["--max_grad_norm", "1.0", "--dp_noise_multiplier", "0.5"]
RESUME_ROUNDS = 4
# the fused_bwd phase's seed. The two runs' tables differ only in the
# order of their f32 sums (~2e-7 of max|table|), but at seed 42 that
# swaps two groups of coordinates sharing one |estimate| at the exact
# top-k's k-th place in rounds 3 and 4, and 64 params end 9.7e-5 apart;
# seeds 1-12 stay within 7.5e-9 for five rounds (python -m
# commefficient_tpu_torch.train.fused_bwd_probe --seeds 42,1-12)
FUSED_BWD_SEED = 1


def dp_stats_ok(x) -> bool:
    """The CPU statistics test's bounds (tests/test_torch_fedsim.py): mean
    within 5 / sqrt(n) of 0 and std within 5 / sqrt(2 n) of 1."""
    n = x.numel()
    x = x.double()
    return (abs(float(x.mean())) <= 5 / n ** 0.5
            and abs(float(x.std()) - 1.0) <= 5 / (2 * n) ** 0.5)


def segment_phase(torch, cs, kern, dev):
    """K1's segment form held against its plain version (atol ``1e-5 *
    max|table|``, K1's f32 tolerance: the order of the sums differs) into
    a table that already holds values, two launches bit-identical, at
    ResNet-9's geometry (its largest and smallest leaves, and every leaf
    of a round, whose tables summed must equal K1 of the whole vector)
    and at GPT-2's (``wte``, 38.6M values, a 768-value bias, and every
    leaf of a round, held to K1 of the whole vector too). Timed by CUDA
    events beside the plain version, one ``index_add_`` per row of
    precomputed signed values (the library call), and the bound: the leaf
    read once plus the table entries it touches read and written once.
    Each line also gives the scratch the geometry allocates. Returns the
    ``kernels`` entry without ``launches``."""
    from commefficient_tpu_torch.ops.cuda import index_math
    from commefficient_tpu_torch.ops.cuda.segment_attribution import cases

    geometries = cases(GEOMETRY, GPT2_GEOMETRY, GPT2_ARGS)
    check(sum(n for _, n in geometries["resnet9_round"][1])
          == GEOMETRY["d"], "segment: ResNet-9 D")
    check(sum(n for _, n in geometries["gpt2_round"][1])
          == GPT2_GEOMETRY["d"], "segment: GPT-2 D")
    rows, worst = {}, 0.0
    for name, (geo, segs) in geometries.items():
        spec = cs.CountSketch(**geo)
        big = geo is GPT2_GEOMETRY
        light = dict(samples=5, calls=2) if big or len(segs) > 1 else {}
        gen = torch.Generator(device=dev).manual_seed(3)
        v = torch.randn(spec.d, generator=gen, device=dev)
        base = torch.randn(spec.table_shape, generator=gen, device=dev)

        def run(fn, table):
            for off, n in segs:
                fn(spec, off, v[off:off + n], table)
            return table

        got = run(kern.sketch_segment, base.clone())
        again = run(kern.sketch_segment, base.clone())
        want = run(kern.sketch_segment_torch, base.clone())
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        check(torch.equal(got, again), f"segment {name}: two launches differ")
        check(err <= tol, f"segment {name}: max err {err} > {tol}")
        del again, want
        if len(segs) > 1:
            whole = base + kern.sketch_rows(spec, cs._scramble(spec, v))
            e2 = float((got - whole).abs().max())
            check(e2 <= tol, f"segment {name}: the leaves' tables differ "
                  f"from K1 of the whole vector by {e2}")
            del whole
        # the library call: one index_add_ per row, signed values and
        # columns precomputed; the bound counts the entries touched
        lo, hi = segs[0][0], segs[-1][0] + segs[-1][1]
        spos = spec.scrambled_pos(torch.arange(lo, hi, device=dev))
        maps = [spec.scrambled_cols_signs(row, spos) for row in range(spec.r)]
        del spos
        src = [v[lo:hi] * sign for _, sign in maps]
        touched = sum(int(torch.unique(cols).numel()) for cols, _ in maps)
        table = base.clone()

        def library():
            for row, (cols, _) in enumerate(maps):
                table[row].index_add_(0, cols, src[row])

        b, by = bound(4 * (hi - lo) + 8 * touched, spec.r * (hi - lo))
        scratch = kern._segment_scratch(spec, str(dev))
        windows = sum(len(index_math.segment_windows(spec.r, n,
                                                     scratch["capacity"]))
                      for _, n in segs if not index_math.segment_small(n))
        rows[name] = dict(
            n=hi - lo, leaves=len(segs), max_abs_err=err, tol=tol,
            ms=cuda_ms(torch, lambda: run(kern.sketch_segment, table),
                       **light),
            plain_ms=cuda_ms(torch, lambda: run(kern.sketch_segment_torch,
                                                table),
                             **(dict(samples=3, calls=1) if big or len(segs)
                                > 1 else {})),
            bound_ms=b, bound_by=by, library_ms=cuda_ms(torch, library,
                                                        **light),
            touched_entries=touched, scratch_bytes=scratch["bytes"],
            two_pass_windows=windows)
        phase("timing", kernel="cs_sketch_segment", geometry=name,
              **rows[name])
        worst = max(worst, err)
        del v, base, got, maps, src, table
        torch.cuda.empty_cache()
    main = rows["resnet9_round"]  # the fused backward's work of a round
    return dict(source=SEGMENT_SOURCE, replaces=SEGMENT_REPLACES,
                max_abs_err=worst,
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                main_geometry="resnet9_round", geometries=rows)


class RoundProbe:
    """Inside ``with RoundProbe(torch) as probe:``, every
    ``FederatedSession.train_round`` and every call of the segment form
    from ``ops/countsketch.py`` is wrapped: ``probe.rounds`` gets one
    ``{"segment_ms", "segment_launches", "max_memory_allocated"}`` a
    round, the first the summed CUDA-event times of the round's segment
    calls (each from just before the call's first kernel is queued to
    just after its last, so it includes any wait for the host to queue
    them), the last the round's peak (reset just before it)."""

    def __init__(self, torch):
        self.torch, self.rounds, self._events = torch, [], None

    def __enter__(self):
        from commefficient_tpu_torch.ops import countsketch as cs_ops
        from commefficient_tpu_torch.parallel import FederatedSession

        torch, probe = self.torch, self
        self._saved = (cs_ops, cs_ops.sketch_segment_kernel,
                       FederatedSession, FederatedSession.train_round)
        seg, train_round = self._saved[1], self._saved[3]

        def timed_segment(*args, **kwargs):
            if probe._events is None:
                return seg(*args, **kwargs)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = seg(*args, **kwargs)
            b.record()
            probe._events.append((a, b))
            return out

        def probed_round(session, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            probe._events = []
            try:
                out = train_round(session, *args, **kwargs)
                torch.cuda.synchronize()
            finally:
                events, probe._events = probe._events, None
            probe.rounds.append(dict(
                segment_ms=sum(a.elapsed_time(b) for a, b in events),
                segment_launches=len(events),
                max_memory_allocated=torch.cuda.max_memory_allocated()))
            return out

        cs_ops.sketch_segment_kernel = timed_segment
        FederatedSession.train_round = probed_round
        return self

    def __exit__(self, *exc):
        cs_ops, seg, cls, train_round = self._saved
        cs_ops.sketch_segment_kernel = seg
        cls.train_round = train_round
        return False

    def print_rounds(self, name: str) -> None:
        for k, r in enumerate(self.rounds):
            phase(f"{name}_round", round=k, **r)


def load_state(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)[
        "fed_state"]


def fused_bwd_phase(torch, kern, cv_train, dataset_dir, work):
    """ResNet-9 at full width, ``--fuse_clients true --sketch_fused_bwd
    true`` (dense decode), MAIN_ROUNDS rounds, the counters set to 0 just
    before and read just after: K1's segment form once a leaf a round,
    K1 twice a round (the weight-decay sketch of the params, the error
    feedback's re-sketch), K2 once; params within ``5e-5 * max(|p|, 1)``
    of the same run with the dense-grad fused gradient (each run's state
    read from its end-of-training checkpoint; both runs on deterministic
    cuDNN at FUSED_BWD_SEED, so their cotangents are the same bits and
    only the sketch's order of sums differs), their momentum tables
    within 1e-5 of max|table|; and the fused gradient table computed
    twice from one state on deterministic cuDNN, bit-identical. Prints
    both runs' round ms, and each round's segment time and peak memory on
    a line of its own (``RoundProbe``)."""
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.parallel.round import (
        leaf_offsets,
        make_sketch_grad_one,
    )
    from commefficient_tpu_torch.utils.config import parse_args

    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same cotangents
    try:
        for name, flags in (("dense_grad", FUSED_FLAGS),
                            ("fused_bwd", FUSED_FLAGS + [
                                "--sketch_fused_bwd", "true"])):
            ck = os.path.join(work, f"fused_{name}")
            kern.reset_launch_counts()
            with RoundProbe(torch) as probe:
                out = cv_train.main(MAIN_ARGS + flags + [
                    "--seed", str(FUSED_BWD_SEED), "--max_rounds",
                    str(MAIN_ROUNDS), "--dataset_dir", dataset_dir,
                    "--checkpoint_dir", ck])
            probe.print_rounds(f"fused_bwd_{name}")
            runs[name] = dict(out=out, forms=kern.form_counts(),
                              launches=kern.launch_counts(),
                              state=load_state(os.path.join(
                                  ck, f"step_{MAIN_ROUNDS}.pt")))
    finally:
        torch.backends.cudnn.deterministic = prev
    cfg = parse_args(MAIN_ARGS + FUSED_FLAGS + ["--sketch_fused_bwd", "true",
                                                "--seed", str(FUSED_BWD_SEED)])
    train, _, _, params, loss_fn, _ = cv_train.build_model_and_data(cfg)
    sess = FederatedSession(cfg, params, loss_fn)
    n_leaves = len(leaf_offsets(sess.unravel, sess.grad_size))
    grad_table = make_sketch_grad_one(cfg, loss_fn, sess.unravel, sess.spec,
                                      sess.grad_size)
    from commefficient_tpu_torch.data import FedSampler

    _, batch = FedSampler(train, num_workers=8, local_batch_size=64,
                          seed=cfg.seed).sample_round(0)
    flat = {k: torch.from_numpy(v.reshape((-1,) + v.shape[2:])).to(
        sess.device) for k, v in batch.items()}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t1 = grad_table(sess.state.params_vec, flat)[0]
        t2 = grad_table(sess.state.params_vec, flat)[0]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    p_d = runs["dense_grad"]["state"]["params_vec"]
    p_f = runs["fused_bwd"]["state"]["params_vec"]
    err = float((p_f - p_d).abs().max())
    tol = 5e-5 * max(1.0, float(p_d.abs().max()))
    over = int(((p_f - p_d).abs() > tol).sum())
    m_d = runs["dense_grad"]["state"]["momentum"]
    m_err = float((runs["fused_bwd"]["state"]["momentum"] - m_d).abs().max()
                  ) / max(float(m_d.abs().max()), 1e-30)
    ms = {k: [h["ms"] for h in r["out"]["history"]] for k, r in runs.items()}
    launches = runs["fused_bwd"]["launches"]
    phase("fused_bwd", leaves=n_leaves, params_max_abs_err=err,
          params_tol=tol, coords_over_tol=over, seed=FUSED_BWD_SEED,
          momentum_table_max_err_over_max=m_err,
          params_moved=runs["dense_grad"]["out"]["param_delta_norm"],
          rerun_tables_bit_identical=torch.equal(t1, t2),
          fused_round_ms=[round(t, 3) for t in ms["fused_bwd"]],
          dense_grad_round_ms=[round(t, 3) for t in ms["dense_grad"]],
          fused_median_after_first=statistics.median(ms["fused_bwd"][1:]),
          dense_grad_median_after_first=statistics.median(
              ms["dense_grad"][1:]),
          launches=launches,
          dense_grad_launches=runs["dense_grad"]["launches"])
    check(err <= tol, f"fused_bwd: params differ by {err} > {tol}")
    check(m_err <= 1e-5, f"fused_bwd: momentum tables differ by {m_err} "
          "of their max (K1's f32 tolerance is 1e-5)")
    check(torch.equal(t1, t2), "fused_bwd: two fused tables from one state "
          "differ")
    for h in runs["fused_bwd"]["out"]["history"]:
        check(math.isfinite(h["loss"]), "fused_bwd: loss not finite")
    for name, want in (("sketch_segment", n_leaves * MAIN_ROUNDS),
                       ("sketch_rows", 2 * MAIN_ROUNDS),
                       ("estimate_median", MAIN_ROUNDS)):
        check(launches[name] == want, f"fused_bwd: {name} launched "
              f"{launches[name]} times, expected {want}")
    check(runs["dense_grad"]["launches"]["sketch_segment"] == 0,
          "fused_bwd: the dense-grad run launched the segment form")
    del sess, t1, t2
    torch.cuda.empty_cache()
    return runs["fused_bwd"]["forms"]


def gpt2_fused_bwd_phase(torch, kern, gpt2_train, dataset_dir, rounds=2):
    """GPT-2 small at full width, ``--max_grad_norm none --fuse_clients
    true``, ``rounds`` rounds with and without ``--sketch_fused_bwd
    true``: each run's round ms and ``torch.cuda.max_memory_allocated``
    (the peak reset just before it), and each round's segment time and
    peak on a line of its own (``RoundProbe``); the fused run launches
    K1's segment form once a leaf a round. Printed, not held to a
    limit."""
    out, forms = {}, None
    for name, extra in (("dense_grad", []),
                        ("fused_bwd", ["--sketch_fused_bwd", "true"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kern.reset_launch_counts()
        with RoundProbe(torch) as probe:
            res = gpt2_train.main(GPT2_ARGS + ["--max_grad_norm", "none"]
                                  + FUSED_FLAGS + extra + [
                "--max_rounds", str(rounds), "--dataset_dir", dataset_dir])
        probe.print_rounds(f"gpt2_fused_bwd_{name}")
        launches = kern.launch_counts()
        ms = [h["ms"] for h in res["history"]]
        out[name] = dict(
            round_ms=[round(t, 3) for t in ms],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=launches)
        check(all(math.isfinite(h["loss"]) for h in res["history"]),
              f"gpt2_fused_bwd {name}: loss not finite")
        check(res["param_delta_norm"] > 0, f"gpt2_fused_bwd {name}: params")
        if name == "fused_bwd":
            forms = kern.form_counts()
            seg = launches["sketch_segment"]
            check(seg > 0 and seg % rounds == 0,
                  f"gpt2_fused_bwd: segment launches {seg}")
    phase("gpt2_fused_bwd", **{f"{k}_{f}": v for k, r in out.items()
                               for f, v in r.items()})
    return forms


def fedsim_phase(torch, kern, cv_train, dataset_dir, dev):
    """ResNet-9 sketch (dense decode) with bernoulli participation at 0.3
    and a straggler plan, MAIN_ROUNDS rounds with the participation
    printed; then the width-8 card-against-CPU agreement with the same
    fedsim flags on deterministic cuDNN."""
    kern.reset_launch_counts()
    out = cv_train.main(MAIN_ARGS + FEDSIM_FLAGS + [
        "--max_rounds", str(MAIN_ROUNDS), "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    rate = [h["fedsim/participation_rate"] for h in hist]
    phase("fedsim", rounds=len(hist), participation_rate=rate,
          dropped=[h["fedsim/dropped"] for h in hist],
          straggler_excluded=[h["fedsim/straggler_excluded"] for h in hist],
          round_ms=[round(h["ms"], 3) for h in hist],
          losses=[h["loss"] for h in hist], launches=launches)
    check(len(hist) == MAIN_ROUNDS, "fedsim: rounds")
    check(all(math.isfinite(h["loss"]) for h in hist), "fedsim: loss")
    check(out["param_delta_norm"] > 0, "fedsim: params did not move")
    check(min(rate) < 1.0, "fedsim: no client ever dropped")
    check(launches["sketch_rows"] == 2 * MAIN_ROUNDS
          and launches["estimate_median"] == MAIN_ROUNDS,
          f"fedsim: launches {launches}")
    forms = kern.form_counts()
    agreement_phase(torch, dev, name="agreement_fedsim",
                    deterministic=True, availability="bernoulli",
                    dropout_prob=0.3, chaos="straggler@0.1")
    return forms


def dp_phase(torch, cv_train, dataset_dir, rounds=3):
    """ResNet-9 ``uncompressed`` with ``--max_grad_norm 1.0
    --dp_noise_multiplier 0.5`` for ``rounds`` rounds through
    ``cv_train.main``; then on the card one client's gradient with and
    without the noise from one state (deterministic cuDNN): their
    difference over sigma is the draw ``dp_noise`` gives for the key, and
    its mean and std lie within the CPU statistics test's bounds."""
    from commefficient_tpu_torch.data import FedSampler
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.parallel.round import dp_noise, make_grad_one
    from commefficient_tpu_torch.utils.config import parse_args

    args = uncompressed_args()
    out = cv_train.main(args + DP_FLAGS + ["--max_rounds", str(rounds),
                                           "--dataset_dir", dataset_dir])
    hist = out["history"]
    cfg = parse_args(args + DP_FLAGS)
    train, _, _, params, loss_fn, _ = cv_train.build_model_and_data(cfg)
    sess = FederatedSession(cfg, params, loss_fn)
    _, batch = FedSampler(train, num_workers=8, local_batch_size=64,
                          seed=cfg.seed).sample_round(0)
    b0 = {k: torch.from_numpy(v[0]).to(sess.device) for k, v in batch.items()}
    key = (7, 3)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        noisy = make_grad_one(cfg, loss_fn, sess.unravel)(
            sess.state.params_vec, b0, key)[0]
        clean = make_grad_one(cfg.replace(dp_noise_multiplier=0.0), loss_fn,
                              sess.unravel)(sess.state.params_vec, b0)[0]
    finally:
        torch.backends.cudnn.deterministic = prev
    sigma = cfg.dp_noise_multiplier * cfg.max_grad_norm
    drawn = (noisy - clean) / sigma
    want = dp_noise(cfg.seed, key, sess.grad_size, sess.device)
    err = float((drawn - want).abs().max())
    x = want.double()
    phase("dp", rounds=len(hist), losses=[h["loss"] for h in hist],
          round_ms=[round(h["ms"], 3) for h in hist],
          param_delta_norm=out["param_delta_norm"], noise_n=want.numel(),
          noise_mean=float(x.mean()), noise_std=float(x.std()),
          in_round_draw_max_abs_err=err)
    check(all(math.isfinite(h["loss"]) for h in hist), "dp: loss")
    check(out["param_delta_norm"] > 0, "dp: params did not move")
    check(dp_stats_ok(want), "dp: the card's draw is outside the bounds")
    check(err <= 1e-4, f"dp: the round's noise differs from its key's draw "
          f"by {err}")
    check(torch.equal(want, dp_noise(cfg.seed, key, sess.grad_size,
                                     sess.device)), "dp: draws not "
          "reproducible")


def resume_phase(torch, kern, cv_train, dataset_dir, work):
    """ResNet-9 sketch (dense decode) on deterministic cuDNN: 2 *
    RESUME_ROUNDS rounds straight, against RESUME_ROUNDS rounds with a
    checkpoint, then a fresh session restored from it for RESUME_ROUNDS
    more (``--resume``), through ``cv_train.main``; every FedState leaf of
    the two end-of-training checkpoints bit-equal. Prints the checkpoint's
    bytes and its save and restore ms."""
    n = 2 * RESUME_ROUNDS
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a, b = os.path.join(work, "straight"), os.path.join(work, "resumed")
        kern.reset_launch_counts()
        cv_train.main(MAIN_ARGS + ["--max_rounds", str(n), "--dataset_dir",
                                   dataset_dir, "--checkpoint_dir", a])
        first = cv_train.main(MAIN_ARGS + [
            "--max_rounds", str(RESUME_ROUNDS), "--dataset_dir", dataset_dir,
            "--checkpoint_dir", b, "--checkpoint_every",
            str(RESUME_ROUNDS)])
        second = cv_train.main(MAIN_ARGS + [
            "--max_rounds", str(n), "--dataset_dir", dataset_dir,
            "--checkpoint_dir", b, "--checkpoint_every", str(RESUME_ROUNDS),
            "--resume", "true"])
        forms = kern.form_counts()
    finally:
        torch.backends.cudnn.deterministic = prev
    sa = load_state(os.path.join(a, f"step_{n}.pt"))
    sb = load_state(os.path.join(b, f"step_{n}.pt"))
    same = {k: (sa[k] is None and sb[k] is None) or bool(
        torch.is_tensor(sa[k]) and torch.equal(sa[k], sb[k]))
        or sa[k] == sb[k] for k in sa}
    ck = second["checkpoint"]
    phase("resume", rounds_straight=n, resumed_from=ck["resumed_from"],
          leaves_bit_equal=json.dumps(same),
          checkpoint_bytes=first["checkpoint"]["bytes"],
          save_ms=first["checkpoint"]["save_ms"],
          restore_ms=ck["restore_ms"],
          resumed_rounds=len(second["history"]))
    check(ck["resumed_from"] == RESUME_ROUNDS, "resume: did not resume")
    check(len(second["history"]) == RESUME_ROUNDS, "resume: rounds")
    check(all(same.values()), f"resume: leaves differ from the straight "
          f"run: {same}")
    return forms


# -- the other datasets, FixupResNet-50, the device-resident training set ----

# FixupResNet-50's FetchSGD geometry: c at the d/c warning's own suggestion
# for D = 25,504,026 at error_decay 1 (parallel/api.py::envelope_warning)
F50_COLS = 1_071_171
F50_GEOMETRY = dict(d=25_504_026, c=F50_COLS, r=5, band=16, seed=42)
F50_CACTUAL = 1_080_848
DATA_ROUNDS = 5
# BASELINE #3: ResNet-9 on FEMNIST (1 channel, 62 classes), local_topk
FEMNIST_FLAGS = ["--dataset_name", "femnist"] + MODE_PATHS["local_topk"][0]
FEMNIST_D = 6_598_654
# BASELINE #5: FixupResNet-50 on ImageNet's 64 px stand-in, 8 clients of 32
# images a local step
IMAGENET_FLAGS = ["--dataset_name", "imagenet", "--model", "fixup_resnet50",
                  "--local_batch_size", "32"]
FEDAVG_FLAGS = ["--mode", "fedavg", "--error_type", "none",
                "--num_local_iters", "2"]
F50_SKETCH_FLAGS = ["--num_cols", str(F50_COLS)]
F50_D = F50_GEOMETRY["d"]
FIXUP_ROUNDS = 3
CIFAR100_ROUNDS = 2
CIFAR100_D = 6_619_300


def f50_kernels_phase(torch, cs, kern, dev):
    """K1 and K2 at FixupResNet-50's geometry: the planner's choices
    (chunk m, riffle factors, realized c, K2's instantiation) printed; K1
    within its f32 tolerance of the plain version and two launches
    bit-identical, K2 exactly the plain version and K4's range form; each
    timed beside its plain version, its bound and, for K1, one
    ``index_add_``. Returns ``{entry: {"fixup_resnet50": numbers}}``."""
    spec = cs.CountSketch(**F50_GEOMETRY)
    r, c, d, d_eff = spec.r, spec.c_actual, spec.d, spec.d_eff
    plan = kern._k2_plan(spec, str(dev))
    inst = (f"<{r},{len(plan['staged'])},"
            f"{str(bool(plan['slot_smem'])).lower()}>")
    phase("f50_geometry", d=d, c=F50_COLS, c_actual=c, chunk_m=spec.chunk_m,
          riffle_factors=[spec._factor(row) for row in range(r)],
          V=[spec.V_row(row) for row in range(r)], k2_instantiation=inst,
          k2_staged_rows=list(plan["staged"]),
          k2_dynamic_smem_bytes=plan["smem_bytes"])
    check(c == F50_CACTUAL, f"F50: c_actual {c}, expected {F50_CACTUAL}")
    light = dict(samples=7, calls=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    v_s = cs._scramble(spec, torch.randn(d, generator=gen, device=dev))
    rows, ptr, off, tile = kern._kernel_geometry(spec, str(dev))[:4]
    t_k = kern.sketch_rows(spec, v_s)
    t_p = kern.sketch_rows_torch(spec, v_s)
    torch.cuda.synchronize()
    err1 = float((t_k - t_p).abs().max())
    tol1 = 1e-5 * max(1.0, float(t_p.abs().max()))
    check(err1 <= tol1, f"K1 at F50: max err {err1} > {tol1}")
    check(torch.equal(t_k, kern.sketch_rows(spec, v_s)),
          "K1 at F50: two launches differ")
    del t_p
    e_k = kern.estimate_median(spec, t_k)
    check(torch.equal(e_k, kern.estimate_median_torch(spec, t_k)),
          "K2 at F50: differs from the plain version")
    check(torch.equal(e_k, kern.estimate_at_range(spec, t_k, 0, d)),
          "K2 at F50: differs from K4's range form")
    del e_k
    maps = kern._plain_maps(spec, str(dev))
    flat_cols = torch.cat([row * c + cols for row, (cols, _)
                           in enumerate(maps)])
    flat_src = torch.cat([v_s * sign for _, sign in maps])
    flat_table = torch.zeros(r * c, device=dev)
    lib1 = cuda_ms(torch, lambda: flat_table.index_add_(0, flat_cols,
                                                        flat_src))
    del flat_cols, flat_src, flat_table
    csr = 4 * (ptr.numel() + off.numel())
    b1, by1 = bound(4 * d_eff + 4 * r * c + csr, r * d_eff)
    b2, by2 = bound(4 * r * c + 4 * plan["perm"].numel() + 4 * d,
                    r * d + r * (r - 1) * d)
    out = {
        "cs_sketch_rows": dict(
            max_abs_err=err1,
            ms=cuda_ms(torch, lambda: kern.sketch_rows(spec, v_s)),
            plain_ms=cuda_ms(torch, lambda: kern.sketch_rows_torch(
                spec, v_s), **light),
            bound_ms=b1, bound_by=by1, library_ms=lib1, tile_strides=tile),
        "cs_estimate_median": dict(
            max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: kern.estimate_median(spec, t_k)),
            plain_ms=cuda_ms(torch, lambda: kern.estimate_median_torch(
                spec, t_k), **light),
            bound_ms=b2, bound_by=by2, library_ms=None, instantiation=inst,
            dynamic_smem_bytes=plan["smem_bytes"])}
    for name, row in out.items():
        phase("timing", kernel=name, geometry="fixup_resnet50", **row)
    del v_s, t_k, maps
    kern._plain_maps.cache_clear()
    torch.cuda.empty_cache()
    return {name: {"fixup_resnet50": row} for name, row in out.items()}


def rrc_phase(torch, dev):
    """``ImageNetAugment.device_apply`` on the card against its numpy
    ``apply`` on one plan, at a BASELINE #5 round's shape (512 images of
    64x64x3): within 1 LSB for uint8 input, within 1e-5 of max|x| for
    float32 input (the stand-in's type). The lerp ``a + (b - a) * t`` is
    f32 on both; the card may contract it into a fused multiply-add."""
    import numpy as np

    from commefficient_tpu_torch.data import ImageNetAugment

    aug = ImageNetAugment()
    rng = np.random.default_rng(0)
    res = {}
    for dtype in ("uint8", "float32"):
        if dtype == "uint8":
            x = rng.integers(0, 256, (512, 64, 64, 3)).astype(np.uint8)
        else:
            x = rng.normal(0, 0.5, (512, 64, 64, 3)).astype(np.float32)
        p = aug.plan(rng, len(x), 64, 64)
        want = aug.apply(x, p).astype(np.float64)
        xd = torch.from_numpy(x).to(dev)
        pd = [torch.from_numpy(np.asarray(a)).to(dev) for a in p]
        got = aug.device_apply(xd, *pd).cpu().numpy().astype(np.float64)
        err = float(np.abs(got - want).max())
        tol = 1.0 if dtype == "uint8" else 1e-5 * float(np.abs(x).max())
        res[dtype] = dict(max_abs_err=err, tol=tol,
                          bit_equal=bool(err == 0.0),
                          ms=cuda_ms(torch, lambda: aug.device_apply(xd, *pd),
                                     samples=7, calls=3))
        check(err <= tol, f"rrc {dtype}: max err {err} > {tol}")
    phase("rrc", **{f"{k}_{f}": v for k, r in res.items()
                    for f, v in r.items()})


def _peak_run(torch, fn):
    """(fn's result, peak ``max_memory_allocated`` during it, bytes
    allocated before it)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    return out, torch.cuda.max_memory_allocated(), before


def device_data_phase(torch, kern, cv_train, dataset_dir, work):
    """The ResNet-9 main path, on the device-resident training set (the
    default) and with ``--device_data false``, DATA_ROUNDS rounds each on
    deterministic cuDNN: the losses and every FedState leaf of the
    end-of-training checkpoints bit-equal (the gather and the CIFAR augment
    are index and select ops, so the inputs are bit-equal). Prints each
    path's round ms, the sampler's host ms before each round, and the peak
    ``max_memory_allocated``."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res, states = {}, {}
    try:
        kern.reset_launch_counts()
        for name, extra in (("device", []),
                            ("host", ["--device_data", "false"])):
            ck = os.path.join(work, f"data_{name}")
            out, peak, before = _peak_run(torch, lambda: cv_train.main(
                MAIN_ARGS + extra + ["--max_rounds", str(DATA_ROUNDS),
                                     "--dataset_dir", dataset_dir,
                                     "--checkpoint_dir", ck]))
            hist = out["history"]
            res[name] = dict(
                data=out["data_path"], losses=[h["loss"] for h in hist],
                round_ms=[round(h["ms"], 3) for h in hist],
                data_ms=[round(h["data_ms"], 3) for h in hist],
                median_round_ms_after_first=statistics.median(
                    h["ms"] for h in hist[1:]),
                median_data_ms_after_first=statistics.median(
                    h["data_ms"] for h in hist[1:]),
                max_memory_allocated=peak, allocated_before=before)
            states[name] = load_state(os.path.join(ck,
                                                   f"step_{DATA_ROUNDS}.pt"))
            check(out["data_path"] == name,
                  f"device_data: data={out['data_path']}, expected {name}")
        forms = kern.form_counts()
    finally:
        torch.backends.cudnn.deterministic = prev
    sa, sb = states["device"], states["host"]
    same = {k: (sa[k] is None and sb[k] is None) or bool(
        torch.is_tensor(sa[k]) and torch.equal(sa[k], sb[k]))
        or sa[k] == sb[k] for k in sa}
    phase("device_data", **{f"{k}_{f}": v for k, r in res.items()
                            for f, v in r.items()},
          leaves_bit_equal=json.dumps(same))
    check(res["device"]["losses"] == res["host"]["losses"],
          "device_data: losses differ between the data paths")
    check(all(same.values()), f"device_data: leaves differ: {same}")
    return forms


def femnist_phase(kern, cv_train, dataset_dir):
    """BASELINE #3 through ``cv_train.main``: ResNet-9 on the FEMNIST
    stand-in (100 clients, ~37 MB, so on the device), local_topk with local
    error feedback and local momentum, 8 clients of 64, DATA_ROUNDS
    rounds: D, the bytes a client and round, ``data=device``, finite
    losses, moved params and no CountSketch kernel."""
    kern.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*dampening=AUTO")
        out = cv_train.main(MAIN_ARGS + FEMNIST_FLAGS + [
            "--max_rounds", str(DATA_ROUNDS), "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    bpr = out["bytes_per_round"]
    phase("femnist_local_topk", D=out["grad_size"], data=out["data_path"],
          rounds=len(hist), round_ms=[round(h["ms"], 3) for h in hist],
          data_ms=[round(h["data_ms"], 3) for h in hist],
          losses=[h["loss"] for h in hist], val_loss=out["loss"],
          val_acc=out.get("accuracy"),
          param_delta_norm=out["param_delta_norm"], bytes_per_round=bpr,
          launches=launches)
    check(out["grad_size"] == FEMNIST_D, "femnist: D")
    check(out["data_path"] == "device", "femnist: expected data=device")
    check(bpr["upload_bytes"] == 400_000
          and bpr["download_bytes"] == 4 * FEMNIST_D, f"femnist: {bpr}")
    check(len(hist) == DATA_ROUNDS, "femnist: rounds")
    check(all(math.isfinite(h["loss"]) for h in hist)
          and math.isfinite(out["loss"]), "femnist: loss not finite")
    check(out["param_delta_norm"] > 0, "femnist: params did not move")
    check(not any(launches.values()), f"femnist: launches {launches}")


BUSY_PATHS = (("host", ["--device_data", "false"], "host"),
              ("device", ["--device_data_max_mb", "1024"], "device"))


def busy_shares(torch, cv_train, args, runs=BUSY_PATHS):
    """The device's busy share of a round for each ``(name, flags, data
    path)`` of ``runs`` over the cv_train flags ``args``
    (``profile_round.round_busy_share``: rounds through the runner's round
    source at the flags' ``pipeline_depth``, the draw in its thread; the
    device kernel time of one profiled round over the mean wall of five
    unprofiled ones), the model, data and sampler built as ``cv_train``
    builds them, one load for all. ``{name: numbers}``."""
    from commefficient_tpu_torch.data import FedSampler
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.train.profile_round import round_busy_share
    from commefficient_tpu_torch.utils.config import parse_args

    out = {}
    train = params = None
    for name, extra, path in runs:
        cfg = parse_args(args + extra)
        if train is None:
            train, _, _, params, loss_fn, augment = (
                cv_train.build_model_and_data(cfg))
        session = FederatedSession(cfg, params, loss_fn)
        sampler = FedSampler(train, num_workers=cfg.num_workers,
                             local_batch_size=cfg.sampler_batch_size,
                             seed=cfg.seed, augment=augment)
        session.maybe_attach_data(train, sampler, augment)
        check(session.data_path == path, f"busy share: data path "
              f"{session.data_path}, expected {path}")
        busy = round_busy_share(session, sampler, 0, 0.1)
        busy.pop("device_ms_by_name")
        out[name] = busy
        del session
    del train, params
    torch.cuda.empty_cache()
    return out


def _median_ms(fn, reps: int = 5) -> float:
    """Median host wall ms of ``fn`` over ``reps`` calls (host work)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def native_phase():
    """The native batch assembly on the card's host: the library built
    (never the numpy fallback: a failed build fails the phase), its g++
    seconds, the cores and OpenMP's threads; one round's assembly at the
    main path's shape (CIFAR prep of 512 uint8 32x32 images; and in
    float32) and at BASELINE #5's (RRC of 512 float32 64x64 images; and
    in uint8), each bit-equal to numpy and timed beside it."""
    import numpy as np

    from commefficient_tpu_torch import native
    from commefficient_tpu_torch.data import CifarAugment, ImageNetAugment

    t0 = time.perf_counter()
    ok = native.available()
    first_call_s = time.perf_counter() - t0
    check(ok, f"native: the library did not build: {native.build_error()}")
    rng = np.random.default_rng(0)
    res = {}
    for name, aug, size, n_data in (("cifar", CifarAugment(), 32, 50_000),
                                    ("rrc", ImageNetAugment(), 64, 4_096)):
        for dtype in ("uint8", "float32"):
            shape = (n_data, size, size, 3)
            x = (rng.integers(0, 256, shape).astype(np.uint8)
                 if dtype == "uint8" else
                 rng.normal(0, 60, shape).astype(np.float32))
            idx = rng.integers(0, n_data, 512)
            p = aug.plan(rng, 512, size, size)
            want = aug.apply(np.ascontiguousarray(x[idx]), p)
            got = aug.gather_apply(x, idx, p)
            check(np.array_equal(got, want),
                  f"native: {name} {dtype} differs from numpy")
            res[f"{name}_{dtype}"] = dict(
                bit_equal=True,
                numpy_ms=_median_ms(lambda: aug.apply(
                    np.ascontiguousarray(x[idx]), p)),
                native_ms=_median_ms(lambda: aug.gather_apply(x, idx, p)))
            del x
    phase("native", available=ok, library=native.library_path().name,
          build_s=native.build_seconds, first_call_s=round(first_call_s, 3),
          cpu_count=os.cpu_count(), omp_threads=native.omp_threads(),
          omp_num_threads_env=os.environ.get("OMP_NUM_THREADS"),
          **{f"{k}_{f}": v for k, r in res.items() for f, v in r.items()})


HOST_PIPELINE_ROUNDS = 5


def host_pipeline_phase(torch, kern, cv_train, dataset_dir, work):
    """The main path at full width (``MAIN_ARGS``, HOST_PIPELINE_ROUNDS
    rounds) on the host path (``--device_data false``) and on the device
    path, each at ``--pipeline_depth`` 0 (the sampler's prefetch thread)
    and 2 (the pipelined engine, staged copies), on deterministic cuDNN:
    each run's round ms and wait ms (median after the first), the
    engine's ``stats()`` at depth 2 (every round staged on the card), K1
    twice and K2 once a round, and the params and every FedState leaf
    after the last round bit-equal across the four runs."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res, states = {}, {}
    n = HOST_PIPELINE_ROUNDS
    try:
        kern.reset_launch_counts()
        for data in ("host", "device"):
            for depth in (0, 2):
                name = f"{data}_depth{depth}"
                ck = os.path.join(work, f"pipeline_{name}")
                extra = (["--device_data", "false"] if data == "host"
                         else []) + ["--pipeline_depth", str(depth)]
                out = cv_train.main(MAIN_ARGS + extra + [
                    "--max_rounds", str(n), "--dataset_dir", dataset_dir,
                    "--checkpoint_dir", ck])
                hist = out["history"]
                check(out["data_path"] == data and len(hist) == n
                      and all(math.isfinite(h["loss"]) for h in hist),
                      f"host_pipeline {name}: data={out['data_path']}, "
                      f"{len(hist)} rounds")
                stats = out["pipeline_stats"]
                if depth:
                    check(stats["rounds"] == n
                          and stats["staged_copies"] == n,
                          f"host_pipeline {name}: staged {stats}")
                res[name] = dict(
                    round_ms=[round(h["ms"], 3) for h in hist],
                    wait_ms=[round(h["data_ms"], 3) for h in hist],
                    median_round_ms_after_first=statistics.median(
                        h["ms"] for h in hist[1:]),
                    median_wait_ms_after_first=statistics.median(
                        h["data_ms"] for h in hist[1:]),
                    losses=[h["loss"] for h in hist], stats=stats)
                states[name] = load_state(os.path.join(ck, f"step_{n}.pt"))
        launches = kern.launch_counts()
        forms = kern.form_counts()
    finally:
        torch.backends.cudnn.deterministic = prev
    ref = states["host_depth0"]
    same = {name: all((ref[k] is None and st[k] is None) or bool(
        torch.is_tensor(ref[k]) and torch.equal(ref[k], st[k]))
        or ref[k] == st[k] for k in ref) for name, st in states.items()}
    phase("host_pipeline", **{f"{k}_{f}": (json.dumps(v) if f == "stats"
                                           else v)
                              for k, r in res.items() for f, v in r.items()},
          leaves_bit_equal_to_host_depth0=json.dumps(same),
          launches=launches)
    for data in ("host", "device"):
        check(same[f"{data}_depth0"] and same[f"{data}_depth2"],
              f"host_pipeline: {data} path's depths differ: {same}")
    check(all(same.values()), f"host_pipeline: leaves differ: {same}")
    check(launches["sketch_rows"] == 2 * 4 * n
          and launches["estimate_median"] == 4 * n,
          f"host_pipeline: launches {launches}")
    return forms


def baseline5_host_phase(torch, cv_train, dataset_dir):
    """BASELINE #5 at the default gate (the 983 MB stand-in over it: the
    host path, the native RRC), FIXUP_ROUNDS rounds through
    ``cv_train.main`` at ``--pipeline_depth`` 0 and 2: each run's round ms
    and wait ms; then the busy share at both depths, measured in turns
    (0, 2, 2, 0)."""
    args = MAIN_ARGS + IMAGENET_FLAGS + FEDAVG_FLAGS
    res = {}
    for depth in (0, 2):
        name = f"depth{depth}"
        out = cv_train.main(args + ["--pipeline_depth", str(depth),
                                    "--max_rounds", str(FIXUP_ROUNDS),
                                    "--dataset_dir", dataset_dir])
        hist = out["history"]
        check(out["data_path"] == "host" and len(hist) == FIXUP_ROUNDS
              and all(math.isfinite(h["loss"]) for h in hist),
              f"baseline5_host {name}: data={out['data_path']}")
        if depth:
            st = out["pipeline_stats"]
            check(st["staged_copies"] == FIXUP_ROUNDS,
                  f"baseline5_host: staged {st}")
        res[name] = dict(round_ms=[round(h["ms"], 3) for h in hist],
                         wait_ms=[round(h["data_ms"], 3) for h in hist],
                         losses=[h["loss"] for h in hist],
                         stats=json.dumps(out["pipeline_stats"]))
    check(res["depth0"]["losses"] == res["depth2"]["losses"],
          "baseline5_host: the depths' losses differ")
    # the depths in turns (0, 2, 2, 0) in one process: the spread between
    # processes is wider than the difference between the depths
    d2 = ["--pipeline_depth", "2"]
    busy = busy_shares(torch, cv_train, args, runs=(
        ("depth0", [], "host"), ("depth2", d2, "host"),
        ("depth2_b", d2, "host"), ("depth0_b", [], "host")))
    for name in ("depth0", "depth2"):
        a, b = busy[name], busy[f"{name}_b"]
        res[name].update({f"busy_{k}": [a[k], b[k]] for k in a
                          if k != "pipeline_depth"})
    phase("baseline5_host", pr10_host_round_ms=589.09,
          pr10_device_round_ms=179.81,
          **{f"{k}_{f}": v for k, r in res.items() for f, v in r.items()})


def imagenet_fedavg_phase(torch, cv_train, dataset_dir):
    """BASELINE #5 through ``cv_train.main``: FixupResNet-50, 1000 classes,
    the 64 px stand-in (983 MB of float32), fedavg with two local steps,
    8 clients of 32 images a step, FIXUP_ROUNDS rounds, twice: at the
    default ``device_data_max_mb`` (the stand-in is over the 512 MB gate:
    the host path, numpy RRC) and at 1024 (the device path, RRC on the
    card). D and the bytes each way; each run's round ms, sampler ms and
    peak memory; then each path's busy share (``busy_shares``)."""
    args = MAIN_ARGS + IMAGENET_FLAGS + FEDAVG_FLAGS
    res = {}
    for name, extra in (("host", []),
                        ("device", ["--device_data_max_mb", "1024"])):
        out, peak, before = _peak_run(torch, lambda: cv_train.main(
            args + extra + ["--max_rounds", str(FIXUP_ROUNDS),
                            "--dataset_dir", dataset_dir]))
        hist = out["history"]
        bpr = out["bytes_per_round"]
        res[name] = dict(data=out["data_path"],
                         losses=[h["loss"] for h in hist],
                         round_ms=[round(h["ms"], 3) for h in hist],
                         data_ms=[round(h["data_ms"], 3) for h in hist],
                         max_memory_allocated=peak, allocated_before=before)
        check(out["data_path"] == name, f"imagenet fedavg: data="
              f"{out['data_path']}, expected {name}")
        check(out["grad_size"] == F50_D, "imagenet fedavg: D")
        check(bpr["upload_bytes"] == bpr["download_bytes"] == 4 * F50_D,
              f"imagenet fedavg: bytes {bpr}")
        check(len(hist) == FIXUP_ROUNDS, "imagenet fedavg: rounds")
        check(all(math.isfinite(h["loss"]) for h in hist)
              and math.isfinite(out["loss"]), "imagenet fedavg: loss")
        check(out["param_delta_norm"] > 0, "imagenet fedavg: params")
    for name, busy in busy_shares(torch, cv_train, args).items():
        res[name].update(busy)
    phase("imagenet_fixup_fedavg", D=F50_D, bytes_each_way=4 * F50_D,
          **{f"{k}_{f}": v for k, r in res.items() for f, v in r.items()})


def imagenet_sketch_phase(torch, kern, cv_train, dataset_dir):
    """FixupResNet-50 with the FetchSGD flags at ``--num_cols`` F50_COLS,
    FIXUP_ROUNDS rounds: no envelope warning, an upload of 5 c_actual
    floats, K1 twice and K2 once a round and no other estimate kernel."""
    kern.reset_launch_counts()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out, peak, _ = _peak_run(torch, lambda: cv_train.main(
            MAIN_ARGS + IMAGENET_FLAGS + F50_SKETCH_FLAGS + [
                "--max_rounds", str(FIXUP_ROUNDS),
                "--dataset_dir", dataset_dir]))
    launches = kern.launch_counts()
    envelope = [str(w.message) for w in rec if "envelope" in str(w.message)]
    hist = out["history"]
    bpr = out["bytes_per_round"]
    phase("imagenet_fixup_sketch", D=out["grad_size"], data=out["data_path"],
          rounds=len(hist), round_ms=[round(h["ms"], 3) for h in hist],
          data_ms=[round(h["data_ms"], 3) for h in hist],
          losses=[h["loss"] for h in hist], bytes_per_round=bpr,
          max_memory_allocated=peak, envelope_warnings=len(envelope),
          launches=launches)
    check(not envelope, f"imagenet sketch: envelope warning {envelope}")
    check(out["grad_size"] == F50_D, "imagenet sketch: D")
    check(bpr["upload_bytes"] == 4 * 5 * F50_CACTUAL,
          f"imagenet sketch: upload {bpr['upload_bytes']}")
    check(len(hist) == FIXUP_ROUNDS
          and all(math.isfinite(h["loss"]) for h in hist),
          "imagenet sketch: rounds or loss")
    check(out["param_delta_norm"] > 0, "imagenet sketch: params")
    for name, want in (("sketch_rows", 2 * FIXUP_ROUNDS),
                       ("estimate_median", FIXUP_ROUNDS), ("estimate_at", 0),
                       ("estimate_at_range", 0), ("median_rows", 0)):
        check(launches[name] == want, f"imagenet sketch: {name} launched "
              f"{launches[name]} times, expected {want}")
    return kern.form_counts()


def cifar100_phase(kern, cv_train, dataset_dir):
    """The main path's flags on CIFAR-100's stand-in (ResNet-9, 100
    classes) for CIFAR100_ROUNDS rounds: D, data=device, K1 twice and K2
    once a round."""
    kern.reset_launch_counts()
    out = cv_train.main(MAIN_ARGS + ["--dataset_name", "cifar100",
                                     "--max_rounds", str(CIFAR100_ROUNDS),
                                     "--dataset_dir", dataset_dir])
    launches = kern.launch_counts()
    hist = out["history"]
    phase("cifar100", D=out["grad_size"], data=out["data_path"],
          round_ms=[round(h["ms"], 3) for h in hist],
          losses=[h["loss"] for h in hist], val_loss=out["loss"],
          launches=launches)
    check(out["grad_size"] == CIFAR100_D, "cifar100: D")
    check(out["data_path"] == "device", "cifar100: expected data=device")
    check(len(hist) == CIFAR100_ROUNDS
          and all(math.isfinite(h["loss"]) for h in hist)
          and out["param_delta_norm"] > 0, "cifar100: loss or params")
    check(launches["sketch_rows"] == 2 * CIFAR100_ROUNDS
          and launches["estimate_median"] == CIFAR100_ROUNDS,
          f"cifar100: launches {launches}")
    return kern.form_counts()


# -- the batched client step --------------------------------------------------


# batched_clients' fedsim masks over the 8 clients: 1 dropped, 2
# corrupted and live, 4 corrupted and dropped
BATCHED_LIVE = [1, 0, 1, 1, 0, 1, 1, 1]
BATCHED_CORRUPT = [0, 0, 1, 0, 1, 0, 0, 0]
# batched_clients' exact hold: tests/test_torch_batched_clients.py's
# (rtol, atol times max|.| of the loop's output), where the two differ only
# in the order of sums. ResNet-9 is held so in f64 compute: in f32 its
# per-client gradient itself moves by ~1e-3 of its max between two f32
# evaluations (the batched step against the loop, the loop against the
# CPU: near-ties of its max-pools; train/batched_probe.py measures it)
BATCHED_TOL = (1e-5, 1e-6)
# the norm hold, where the exact hold cannot apply (the paths' own bf16
# compute, where near-ties flip far more often; GPT-2 in f32, whose long
# sums in wte and mc_head move by a few 1e-6 of max|.| between two
# summation orders; GPT-2 in f64 does not fit the batched step):
# each vector output's L2 distance from the loop's at most NORM_FACTOR
# times the loop's own distance from an exact loop (f64 compute) plus
# BATCHED_TOL's rtol times the loop's norm; the loss sum likewise, with
# the compute type's unit roundoff in place of the rtol
NORM_FACTOR = 2.0


def batched_cases():
    """batched_clients' ResNet-9 configurations: name -> (flags, fedsim
    masks or None), tests/test_torch_batched_clients.py's at full width
    (every configuration has MAIN_ARGS's weight decay, 5e-4)."""
    unc = uncompressed_args()
    local_topk = MAIN_ARGS + MODE_PATHS["local_topk"][0]
    return {
        "sketch": (MAIN_ARGS, None),
        "sketch_local_momentum": (MAIN_ARGS + ["--local_momentum", "0.9"],
                                  None),
        "local_topk_exact": (local_topk, None),
        "local_topk_threshold": (local_topk + ["--topk_method",
                                               "threshold"], None),
        "fedavg": (MAIN_ARGS + MODE_PATHS["fedavg"][0], None),
        "true_topk": (MAIN_ARGS + MODE_PATHS["true_topk"][0], None),
        "powersgd": (MAIN_ARGS + MODE_PATHS["powersgd"][0], None),
        "uncompressed": (unc, None),
        "weight_decay_clip": (unc + ["--max_grad_norm", "1.0"], None),
        "clip_dp": (unc + DP_FLAGS, None),
        "fedsim": (local_topk, (BATCHED_LIVE, BATCHED_CORRUPT)),
    }


def _close(torch, a, b, rtol, atol):
    """(``|a - b| <= atol * max|b| + rtol * |b|`` everywhere, max |a - b|
    over max|b|)."""
    scale = float(torch.max(torch.abs(b)))
    diff = torch.abs(a - b)
    ok = bool(torch.all(diff <= atol * scale + rtol * torch.abs(b)))
    return ok, float(torch.max(diff)) / (scale or 1.0)


def _step_err(torch, got, want, rtol, atol, nan_sum):
    """(within the tolerance, the largest ``_close`` error) of two client
    steps' outputs; with ``nan_sum`` (a corrupted live client) both
    transmit sums must be NaN everywhere."""
    pairs = ([("transmit", got[0], want[0]), ("loss", got[1], want[1])]
             + [(k, got[2][k], want[2][k]) for k in want[2]]
             + [("vel", got[3], want[3]), ("err", got[4], want[4])])
    ok, worst = True, 0.0
    for what, a, b in pairs:
        if b is None:
            ok &= a is None
        elif what == "transmit" and nan_sum:
            ok &= bool(torch.isnan(a).all() and torch.isnan(b).all())
        else:
            good, err = _close(torch, a, b, rtol, atol)
            ok, worst = ok and good, max(worst, err)
    return ok, worst


def _norm_hold(torch, got, want, exact, nan_sum, eps):
    """(within the norm hold, the largest ratio of the batched step's
    distance from the loop to the loop's from ``exact``) over the
    transmit sum, the new rows and the loss sum (a scalar: its room is
    ``eps``, the compute type's, times the loop's loss, not BATCHED_TOL's
    rtol); NaN sums (a corrupted live client): both NaN everywhere. The
    aux are argmax counts and the loss's parts, not held here."""
    ok, worst = True, 0.0
    for i in (0, 3, 4, 1):
        a, b, x = got[i], want[i], exact[i]
        if b is None:
            ok &= a is None
        elif i == 0 and nan_sum:
            ok &= bool(torch.isnan(a).all() and torch.isnan(b).all())
        else:
            d_bl = float(torch.linalg.vector_norm(a - b))
            d_lx = float(torch.linalg.vector_norm(b - x))
            room = (eps if i == 1 else BATCHED_TOL[0]) * float(
                torch.linalg.vector_norm(b))
            ok &= d_bl <= NORM_FACTOR * d_lx + room
            if i != 1:
                worst = max(worst, d_bl / max(d_lx, 1e-30))
    return ok, worst


def client_step(torch, sess, loss_fn, ids, batch, env, lr=0.1):
    """``(grad_one, per_client, the client step's arguments)`` of the
    session's state and ``batch`` under ``loss_fn``."""
    from commefficient_tpu_torch.parallel.round import (
        client_inputs,
        make_grad_one,
        make_per_client,
    )

    grad_one = make_grad_one(sess.cfg, loss_fn, sess.unravel)
    return (grad_one, make_per_client(sess.cfg, sess.compressor, grad_one),
            client_inputs(sess.cfg, sess.compressor, sess.state, ids, batch,
                          lr, env))


def hold_client_step(torch, sess, loss_fn, ids, batch, env, timed,
                     exact=None, eps=None):
    """The batched client step against the per-client loop on the
    session's state and ``batch``, with each call's peak
    ``max_memory_allocated``: without ``exact``, the outputs held at
    BATCHED_TOL (where a top-k selects per client, local error feedback,
    and the k-th gap of some client's pre-selection vector is inside the
    tolerance, a flipped near-tie is the order of the sums, not a fault:
    the per-client gradients are held instead); with ``exact`` (an exact
    loop's outputs), the norm hold (``_norm_hold``, the loss's room
    ``eps``, the compute type's unit roundoff). With ``timed``, both
    timed by CUDA events (median of 3 after 3 warm-up calls). Returns
    (the row, the loop's outputs)."""
    from commefficient_tpu_torch.parallel.round import (
        batched_client_transmits,
        client_transmits,
    )

    cfg = sess.cfg
    rtol, atol = BATCHED_TOL
    grad_one, per_client, args = client_step(torch, sess, loss_fn, ids,
                                             batch, env)
    steps = (("loop", client_transmits),
             ("batched", batched_client_transmits))
    out, peaks = {}, {}
    for name, fn in steps:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[name] = fn(per_client, *args)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
    nan_sum = env is not None and any(a and b for a, b in zip(env.live,
                                                              env.corrupt))
    params, b, vel, err_rows, lr_c = args[:5]
    if exact is not None:
        held = (f"norm: within {NORM_FACTOR} x the loop's distance from "
                f"the exact loop")
        ok, err = _norm_hold(torch, out["batched"], out["loop"], exact,
                             nan_sum, eps)
    else:
        held = "outputs"
        ok, err = _step_err(torch, out["batched"], out["loop"], rtol, atol,
                            nan_sum)
    if exact is None and err_rows is not None:  # a top-k per client
        g = torch.func.vmap(grad_one, in_dims=(None, 0))(params, b)[0]
        e = err_rows + lr_c * (cfg.local_momentum * vel + g)
        top = torch.topk(torch.abs(e), cfg.k + 1, dim=-1).values
        gap = float(torch.min(top[:, cfg.k - 1] - top[:, cfg.k]))
        if gap <= (rtol + atol) * float(torch.max(torch.abs(e))):
            g0 = torch.stack([grad_one(params, {k: v[i] for k, v in
                                                b.items()})[0]
                              for i in range(g.shape[0])])
            held = "pre-selection gradients"
            ok, err = _close(torch, g, g0, rtol, atol)
            del g0
        del g, e, top
    if env is not None:  # masked clients' rows carry forward bit for bit
        off = torch.tensor([m == 0 for m in env.live], device=params.device)
        for new, old in ((out["batched"][3], vel),
                         (out["batched"][4], err_rows)):
            ok &= old is None or bool(torch.equal(new[off], old[off]))
    loop = out.pop("loop")
    del out
    row = dict(held=held, ok=ok, error=err, loop_peak_bytes=peaks["loop"],
               batched_peak_bytes=peaks["batched"])
    if timed:
        ms = {name: cuda_ms(torch, lambda fn=fn: fn(per_client, *args),
                            samples=3, calls=1) for name, fn in steps}
        row.update(loop_ms=ms["loop"], batched_ms=ms["batched"],
                   speedup=ms["loop"] / ms["batched"])
    return row, loop


def batched_clients_phase(torch, cv_train, gpt2_train, dataset_dir):
    """The batched client step (``batched_client_transmits``, one
    ``torch.func.vmap`` over the per-client function) against its plain
    version, the per-client loop (``client_transmits``), on the card, on
    a session's state after one round and the next round's batch: each
    of ``batched_cases()`` at ResNet-9's full width, held in f64 compute
    at BATCHED_TOL and in the main path's mixed compute by the norm hold
    against the f64 loop, timed in mixed; then GPT-2 BASELINE #4
    (``GPT2_ARGS``, clip 1.0) in f32 and in its bf16 compute, each by the
    norm hold against the loop in f64 compute, timed, with each call's
    peak memory. The f64 runs are on deterministic cuDNN."""
    import dataclasses
    import functools

    import numpy as np

    from commefficient_tpu_torch.data import FedSampler
    from commefficient_tpu_torch.fedsim import RoundEnv
    from commefficient_tpu_torch.models.gpt2 import gpt2_apply
    from commefficient_tpu_torch.models.losses import (
        classification_loss,
        gpt2_double_heads_loss,
    )
    from commefficient_tpu_torch.models.resnet9 import resnet9_apply
    from commefficient_tpu_torch.parallel import FederatedSession, mask_gpt2
    from commefficient_tpu_torch.parallel.api import _to_device, microbatched
    from commefficient_tpu_torch.utils.config import parse_args

    prev = torch.backends.cudnn.deterministic

    def session_at_round_1(cfg, params, loss_fn, train, **kw):
        sess = FederatedSession(cfg, params, loss_fn, **kw)
        sampler = FedSampler(train, num_workers=cfg.num_workers,
                             local_batch_size=cfg.sampler_batch_size,
                             seed=cfg.seed)
        ids, b = sampler.sample_round(0)
        sess.train_round(ids, microbatched(cfg, b), 0.1)
        ids, b = sampler.sample_round(1)
        return sess, torch.as_tensor(ids.astype(np.int64),
                                     device=sess.device), _to_device(
            microbatched(cfg, b), sess.device)

    def hold(name, compute, sess, loss_fn, ids, batch, env, timed,
             exact=None):
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = compute == "float64" or prev
        eps = torch.finfo(torch.bfloat16 if compute == "mixed"
                          else getattr(torch, compute)).eps
        try:
            r, loop = hold_client_step(torch, sess, loss_fn, ids, batch, env,
                                       timed, exact, eps)
        finally:
            torch.backends.cudnn.deterministic = prev
        phase("batched_clients", case=name, compute=compute, **r)
        check(r["ok"], f"batched_clients {name} ({compute}): the batched "
              f"step differs from the loop ({r['held']}: {r['error']})")
        rows[f"{name}/{compute}"] = r
        return loop

    rows = {}
    base = parse_args(MAIN_ARGS + ["--dataset_dir", dataset_dir])
    train, _, _, params, loss_mixed, _ = cv_train.build_model_and_data(base)
    loss_f64 = classification_loss(
        functools.partial(resnet9_apply, dtype=torch.float64),
        prep=cv_train.normalizer(cv_train.CIFAR10_MEAN,
                                 cv_train.CIFAR10_STD))
    for name, (flags, masks) in batched_cases().items():
        cfg = parse_args(flags + ["--dataset_dir", dataset_dir])
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*dampening=AUTO")
            sess, ids, batch = session_at_round_1(cfg, params, loss_mixed,
                                                  train)
            env = None if masks is None else RoundEnv(
                np.float32(masks[0]), np.float32(masks[1]),
                np.float32(sum(masks[0])), {})
            exact = hold(name, "float64", sess, loss_f64, ids, batch, env,
                         False)
            hold(name, "mixed", sess, loss_mixed, ids, batch, env, True,
                 exact)
        del sess, batch
    del train, params
    # GPT-2 BASELINE #4: clip 1.0, the per-client path
    cfg = parse_args(GPT2_ARGS + ["--dataset_dir", dataset_dir],
                     defaults=gpt2_train.DEFAULTS)
    train, _, _, _, gcfg, params, loss_bf16 = (
        gpt2_train.build_model_and_data(cfg))
    def loss_in(dtype):
        return gpt2_double_heads_loss(
            functools.partial(gpt2_apply, cfg=dataclasses.replace(
                gcfg, dtype=dtype)), cfg.lm_coef, cfg.mc_coef,
            compute_dtype="float32")

    sess, ids, batch = session_at_round_1(cfg, params, loss_bf16, train,
                                          mask_batch=mask_gpt2)
    del params
    from commefficient_tpu_torch.parallel.round import client_transmits

    torch.backends.cudnn.deterministic = True
    try:
        _, per_client, args = client_step(torch, sess,
                                          loss_in(torch.float64), ids,
                                          batch, None)
        exact = client_transmits(per_client, *args)
        del per_client, args
    finally:
        torch.backends.cudnn.deterministic = prev
    hold("gpt2", "float32", sess, loss_in(torch.float32), ids, batch, None,
         True, exact)
    hold("gpt2", "bfloat16", sess, loss_bf16, ids, batch, None, True, exact)
    del sess, batch
    torch.cuda.empty_cache()
    return rows
# -- the decode options, sparse aggregation, overlap, FSDP ---------------------

NEW_ROUNDS = 3  # rounds of each run of the phases below
SPARSE_PATHS = {  # path -> flags over MAIN_ARGS (the threshold top-k;
    # local_topk with the default 16 clients: its two [16, D] banks, not
    # the mode phase's [100, D], go into each run's checkpoint)
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9", "--topk_method", "threshold"],
    "true_topk": ["--mode", "true_topk", "--topk_method", "threshold"],
    "sketch": SHARDED_FLAGS,
}
FSDP_FLAGS = ["--fsdp", "true", "--topk_method", "threshold"]


class CachedCifar:
    """Inside ``with CachedCifar(cv_train):`` ``cv_train``'s CIFAR-10
    loader returns the dataset it built for the same arguments before (a
    pure function of them: the synthetic stand-in is drawn from the seed),
    so the short runs below do not each spend seconds drawing it."""

    def __init__(self, cv_train):
        self.cv_train, self.saved = cv_train, cv_train.load_fed_cifar10

    def __enter__(self):
        import functools

        self.cv_train.load_fed_cifar10 = functools.lru_cache(maxsize=4)(
            self.saved)
        return self

    def __exit__(self, *exc):
        self.cv_train.load_fed_cifar10 = self.saved


def state_run(torch, kern, cv_train, dataset_dir, work, name, args,
              rounds=NEW_ROUNDS):
    """``cv_train.main(args)`` for ``rounds`` rounds on deterministic
    cuDNN with the launch counters set to 0 just before and read just
    after: the result, the end-of-training checkpoint's state, the
    launches and forms, the peak ``max_memory_allocated``, each round's
    ms, and the warnings given. Fails on a non-finite loss or eval loss."""
    ck = os.path.join(work, name)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            kern.reset_launch_counts()
            out, peak, _ = _peak_run(torch, lambda: cv_train.main(
                args + ["--max_rounds", str(rounds), "--dataset_dir",
                        dataset_dir, "--checkpoint_dir", ck]))
            launches, forms = kern.launch_counts(), kern.form_counts()
    finally:
        torch.backends.cudnn.deterministic = prev
    hist = out["history"]
    check(len(hist) == rounds, f"{name}: {len(hist)} rounds")
    check(all(math.isfinite(h["loss"]) for h in hist)
          and math.isfinite(out["loss"]), f"{name}: loss not finite")
    return dict(out=out, state=load_state(os.path.join(
        ck, f"step_{rounds}.pt")), launches=launches, forms=forms,
        peak=peak, round_ms=[round(h["ms"], 3) for h in hist],
        warned=sorted({str(w.message)[:48] for w in caught
                       if "degenerate" in str(w.message)}))


def state_diff(torch, a, b, d):
    """(bit-equal, max abs difference) over every FedState leaf of two
    checkpoints, a padded sharded leaf cut to its first d entries."""
    same, err = True, 0.0
    for k in a:
        x, y = a[k], b[k]
        if not torch.is_tensor(x) or not torch.is_tensor(y):
            same = same and x == y
            continue
        if x.dim() == 1 and x.numel() != y.numel():
            x, y = x[:d], y[:d]
        same = same and torch.equal(x, y)
        err = max(err, float((x.float() - y.float()).abs().max())
                  if x.numel() else 0.0)
    return same, err


def decode_options_phase(torch, cs, kern, cv_train, dataset_dir, work, dev):
    """``num_blocks``: the main path's flags (dense decode, exact top-k)
    with ``--num_blocks 4`` against ``--num_blocks 1``, NEW_ROUNDS rounds
    each: every FedState leaf bit-equal, K2 once a round at 1 and K4's
    range form 4 times a round (its four slices, the last padded by
    repeating d - 1) and K2 never at 4, each run's round ms and peak
    memory; and ``estimate_all`` at num_blocks 4 held exactly to K2 and to
    the range form's plain version slice by slice on a random table, and
    timed beside num_blocks 1 (K2).
    ``approx``: ``--topk_method approx`` against the exact run, bit-equal
    (off a TPU ``lax.approx_max_k`` is the exact selection). Returns the
    runs' launch forms by path."""
    spec1 = cs.CountSketch(**GEOMETRY)
    spec4 = cs.CountSketch(num_blocks=4, **GEOMETRY)
    gen = torch.Generator(device=dev).manual_seed(17)
    table = torch.randn(spec1.table_shape, generator=gen, device=dev)
    kern.reset_launch_counts()
    got = cs.estimate_all(spec4, table)
    k2 = cs.estimate_all(spec1, table)
    blk = -(-spec4.d // 4)
    plain = torch.cat([kern.estimate_at_range_torch(spec4, table, s, blk)
                       for s in range(0, spec4.d, blk)])[:spec4.d]
    torch.cuda.synchronize()
    check(kern.launch_counts()["estimate_at_range"] == 4,
          "num_blocks: estimate_all(num_blocks=4) is not 4 range launches")
    check(torch.equal(got, plain) and torch.equal(got, k2),
          "num_blocks: K4's range form over the 4 slices differs from its "
          "plain version or from K2")
    est_ms = {f"estimate_all_ms_{n}": cuda_ms(torch, lambda sp=sp: (
        cs.estimate_all(sp, table))) for n, sp in ((1, spec1), (4, spec4))}
    del table, got, k2, plain
    runs = {"num_blocks_1": state_run(torch, kern, cv_train, dataset_dir,
                                      work, "nb1", MAIN_ARGS),
            "num_blocks_4": state_run(torch, kern, cv_train, dataset_dir,
                                      work, "nb4",
                                      MAIN_ARGS + ["--num_blocks", "4"]),
            "approx": state_run(torch, kern, cv_train, dataset_dir, work,
                                "approx", MAIN_ARGS + ["--topk_method",
                                                       "approx"])}
    d = GEOMETRY["d"]
    same4, err4 = state_diff(torch, runs["num_blocks_4"]["state"],
                             runs["num_blocks_1"]["state"], d)
    same_a, err_a = state_diff(torch, runs["approx"]["state"],
                               runs["num_blocks_1"]["state"], d)
    fields = {f"{k}_{f}": v for k, r in runs.items() for f, v in (
        ("k2_launches", r["launches"]["estimate_median"]),
        ("k4_launches", r["launches"]["estimate_at_range"]),
        ("round_ms", r["round_ms"]), ("max_memory_allocated", r["peak"]))}
    phase("num_blocks", rounds=NEW_ROUNDS, estimate_all_equals_k2=True,
          **est_ms, leaves_bit_equal=same4, max_abs_err=err4,
          **{k: v for k, v in fields.items() if k.startswith("num_b")})
    phase("approx", rounds=NEW_ROUNDS, leaves_bit_equal=same_a,
          max_abs_err=err_a, **{k: v for k, v in fields.items()
                                if k.startswith("approx")})
    check(same4, f"num_blocks 4 differs from 1 (max err {err4})")
    check(same_a, f"approx differs from exact (max err {err_a})")
    for name, k2, k4 in (("num_blocks_1", NEW_ROUNDS, 0),
                         ("num_blocks_4", 0, 4 * NEW_ROUNDS),
                         ("approx", NEW_ROUNDS, 0)):
        ln = runs[name]["launches"]
        check(ln["estimate_median"] == k2 and ln["estimate_at_range"] == k4
              and ln["sketch_rows"] == 2 * NEW_ROUNDS,
              f"{name}: launches {ln}")
    return {k: r["forms"] for k, r in runs.items()}


def pair_exchange_ms(torch, dev):
    """The one-card cost of local_topk's sparse aggregation at the main
    path's shape: ``sparse_allreduce`` (compaction at capacity 8 * 50,000,
    the pairs' scatter) of a vector with 400,000 nonzeros, on a group of
    one, where the dense sum it replaces is the identity; its result is
    held bit-equal to the vector."""
    from commefficient_tpu_torch.ops.collectives import sparse_allreduce
    from commefficient_tpu_torch.parallel.mesh import SingleWorker

    gen = torch.Generator(device=dev).manual_seed(23)
    v = torch.zeros(D_FULL, device=dev)
    hot = torch.randperm(D_FULL, generator=gen, device=dev)[:400_000]
    v[hot] = torch.randn(hot.numel(), generator=gen, device=dev)
    group = SingleWorker()
    check(torch.equal(sparse_allreduce(v, 400_000, group), v),
          "sparse_allreduce on one card differs from its input")
    return cuda_ms(torch, lambda: sparse_allreduce(v, 400_000, group))


def sparse_aggregate_phase(torch, kern, cv_train, dataset_dir, work):
    """local_topk (threshold), true_topk (threshold) and sketch (sharded
    decode, threshold) with ``--aggregate sparse`` against ``dense``,
    NEW_ROUNDS rounds each on one card: ``aggregate_resolved`` and the
    one-device warning printed; every FedState leaf bit-equal or within
    the CPU twins' 1e-5; local_topk's ``sparse_allreduce`` alone timed at
    its capacity (``pair_exchange_ms``); sketch's K4 range form once and K1 twice a round
    either way (the error feedback riding the pair exchange: one
    ``sketch_sparse`` of the gathered pairs). Returns the runs (the FSDP
    phase holds its rounds against the dense ones)."""
    runs, forms = {}, {}
    for name, flags in SPARSE_PATHS.items():
        for agg in ("dense", "sparse"):
            runs[f"{name}_{agg}"] = r = state_run(
                torch, kern, cv_train, dataset_dir, work, f"agg_{name}_{agg}",
                MAIN_ARGS + flags + ["--aggregate", agg])
            forms[f"aggregate_{name}_{agg}"] = r["forms"]
        dense, sparse = runs[f"{name}_dense"], runs[f"{name}_sparse"]
        same, err = state_diff(torch, sparse["state"], dense["state"],
                               GEOMETRY["d"])
        extra = ({"sparse_allreduce_ms": pair_exchange_ms(
            torch, torch.device("cuda"))} if name == "local_topk" else {})
        phase("sparse_aggregate", path=name, **extra,
              aggregate_resolved=sparse["out"]["aggregate"],
              dense_resolved=dense["out"]["aggregate"],
              warning=json.dumps(sparse["warned"]), leaves_bit_equal=same,
              max_abs_err=err, round_ms_dense=dense["round_ms"],
              round_ms_sparse=sparse["round_ms"],
              launches_sparse=json.dumps({k: v for k, v in
                                          sparse["launches"].items() if v}))
        check(sparse["out"]["aggregate"] == "sparse"
              and dense["out"]["aggregate"] == "dense",
              f"sparse_aggregate {name}: resolved aggregation")
        check(any("aggregate='sparse'" in w for w in sparse["warned"]),
              f"sparse_aggregate {name}: no one-device warning")
        check(err <= 1e-5, f"sparse_aggregate {name}: max err {err}")
        if name == "sketch":
            for r in (dense, sparse):
                check(r["launches"]["estimate_at_range"] == NEW_ROUNDS
                      and r["launches"]["sketch_rows"] == 2 * NEW_ROUNDS,
                      f"sparse_aggregate sketch: launches {r['launches']}")
    return runs, forms


def overlap_phase(torch, kern, cv_train, dataset_dir, work):
    """``--fuse_clients true --sketch_fused_bwd true --overlap_collectives
    layerwise``, NEW_ROUNDS rounds: K1's segment form once a leaf a round
    (each leaf into its group's table), its params beside the fused
    phase's; and the group tables of one state and batch, summed in group
    order, within the segment form's ``1e-5 * max|table|`` of the
    monolithic fused table (deterministic cuDNN: the same cotangents)."""
    from commefficient_tpu_torch.data import FedSampler
    from commefficient_tpu_torch.ops.collectives import OVERLAP_SEGMENTS
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.parallel.round import (
        leaf_offsets,
        make_sketch_grad_one,
    )
    from commefficient_tpu_torch.utils.config import parse_args

    flags = MAIN_ARGS + FUSED_FLAGS + [
        "--sketch_fused_bwd", "true", "--seed", str(FUSED_BWD_SEED)]
    run = state_run(torch, kern, cv_train, dataset_dir, work, "overlap",
                    flags + ["--overlap_collectives", "layerwise"])
    cfg = parse_args(flags + ["--overlap_collectives", "layerwise"])
    train, _, _, params, loss_fn, _ = cv_train.build_model_and_data(cfg)
    sess = FederatedSession(cfg, params, loss_fn)
    n_leaves = len(leaf_offsets(sess.unravel, sess.grad_size))
    groups = make_sketch_grad_one(cfg, loss_fn, sess.unravel, sess.spec,
                                  sess.grad_size,
                                  overlap_segments=OVERLAP_SEGMENTS)
    mono = make_sketch_grad_one(cfg, loss_fn, sess.unravel, sess.spec,
                                sess.grad_size)
    _, batch = FedSampler(train, num_workers=8, local_batch_size=64,
                          seed=cfg.seed).sample_round(0)
    flat = {k: torch.from_numpy(v.reshape((-1,) + v.shape[2:])).to(
        sess.device) for k, v in batch.items()}
    order = []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tables = groups(sess.state.params_vec, flat,
                        on_group=lambda g, t: order.append(g))[0]
        want = mono(sess.state.params_vec, flat)[0]
        total = tables[0].clone()
        for t in tables[1:]:
            total += t
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    err = float((total - want).abs().max()) / max(float(want.abs().max()),
                                                   1e-30)
    seg = run["launches"]["sketch_segment"]
    phase("overlap", groups=len(tables), leaves=n_leaves,
          groups_reported_in_order=json.dumps(order),
          group_sum_max_err_over_max=err, segment_launches=seg,
          round_ms=run["round_ms"], max_memory_allocated=run["peak"],
          param_delta_norm=run["out"]["param_delta_norm"])
    check(sorted(order) == list(range(len(tables))) == list(range(
        OVERLAP_SEGMENTS)), f"overlap: groups reported {order}")
    check(err <= 1e-5, f"overlap: group-table sum off by {err} of max")
    check(seg == n_leaves * NEW_ROUNDS,
          f"overlap: segment form launched {seg} times, expected "
          f"{n_leaves} a round")
    return run["forms"]


def fsdp_phase(torch, kern, cv_train, dataset_dir, work, agg_runs):
    """sketch (threshold), true_topk (threshold) and uncompressed with
    ``--fsdp true``, NEW_ROUNDS rounds each on one card, against the
    replicated round with the same flags (the sparse phase's dense runs;
    a replicated uncompressed run): every FedState leaf (the FSDP params
    and dense leaves cut from their padded layout) within the CPU twins'
    2e-5 (the reference's FSDP-vs-replicated bound), bit-equality printed;
    FSDP sketch's K4 range form once and K1 twice a round."""
    repl = {"sketch": agg_runs["sketch_dense"],
            "true_topk": agg_runs["true_topk_dense"],
            "uncompressed": state_run(
                torch, kern, cv_train, dataset_dir, work, "uncompressed_repl",
                uncompressed_args() + ["--topk_method", "threshold"])}
    flags = {"sketch": SPARSE_PATHS["sketch"],
             "true_topk": SPARSE_PATHS["true_topk"]}
    forms = {}
    for name, rep in repl.items():
        args = (uncompressed_args() if name == "uncompressed"
                else MAIN_ARGS + flags[name])
        run = state_run(torch, kern, cv_train, dataset_dir, work,
                        f"fsdp_{name}", args + FSDP_FLAGS)
        forms[f"fsdp_{name}"] = run["forms"]
        same, err = state_diff(torch, run["state"], rep["state"],
                               GEOMETRY["d"])
        phase("fsdp", path=name, leaves_bit_equal=same, max_abs_err=err,
              data=run["out"]["data_path"], round_ms_fsdp=run["round_ms"],
              round_ms_replicated=rep["round_ms"],
              max_memory_allocated_fsdp=run["peak"],
              launches=json.dumps({k: v for k, v in run["launches"].items()
                                   if v}))
        check(err <= 2e-5, f"fsdp {name}: max err {err}")
        if name == "sketch":
            ln = run["launches"]
            check(ln["estimate_at_range"] == NEW_ROUNDS
                  and ln["sketch_rows"] == 2 * NEW_ROUNDS
                  and ln["estimate_median"] == 0, f"fsdp sketch: {ln}")
    return forms


TEL_ROUNDS = 3  # rounds of each telemetry run
TEL_GPT2_ROUNDS = 2
# each level's launches over TEL_ROUNDS rounds of the main path: K1 twice a
# round (+1 at level 2: the fidelity's sketch_sparse), K2 once, K3 twice at
# level >= 1 (the AMS estimates of the aggregate and the error table), K4's
# index form once at level 2 (the fidelity's re-estimate)
TEL_LAUNCHES = {
    0: dict(sketch_rows=2, estimate_median=1, median_rows=0, estimate_at=0),
    1: dict(sketch_rows=2, estimate_median=1, median_rows=2, estimate_at=0),
    2: dict(sketch_rows=3, estimate_median=1, median_rows=2, estimate_at=1),
}


def _no_bare_constant(tok):
    raise AssertionError(f"bare {tok} token: not strict JSON")


def read_metrics(logdir):
    """``{name: {step: value}}`` of a run dir's ``metrics.jsonl``, every
    line parsed as strict JSON and every scalar record carrying ``t``."""
    out, headers = {}, 0
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line, parse_constant=_no_bare_constant)
            if rec.get("type") == "header":
                headers += 1
                continue
            check("t" in rec, f"{logdir}: a record without t")
            out.setdefault(rec["name"], {})[rec["step"]] = rec["value"]
    check(headers == 1, f"{logdir}: {headers} headers")
    return out


def add_forms(*forms):
    """The sum of ``form_counts()`` dicts."""
    out = {}
    for f in forms:
        for w, by in f.items():
            acc = out.setdefault(w, {})
            for k, n in by.items():
                acc[k] = acc.get(k, 0) + n
    return out


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device ms of one call of ``fn``: the summed time of the CUDA
    kernels ``torch.profiler`` records over ``calls`` calls, over
    ``calls`` (the host's launch time left out)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages())
    return us / 1e3 / calls


def diag_cost_ms(torch, cs, geometry, k, level, dev):
    """Ms of one call of the round's diagnostics (``round_diagnostics`` of
    a sketch round with virtual error and momentum) at ``geometry`` on
    random tensors of the round's shapes (the aggregate and error tables,
    a k-sparse ``[D]`` update, ``[D]`` params), and of its pieces: by CUDA
    events over back-to-back calls (bound by whichever of the host's
    launches and the device's work is slower) and the device's own time
    (``device_ms``)."""
    from types import SimpleNamespace

    from commefficient_tpu_torch.compress import get_compressor
    from commefficient_tpu_torch.compress.base import sqnorm
    from commefficient_tpu_torch.telemetry import round_diagnostics
    from commefficient_tpu_torch.telemetry.diagnostics import all_finite
    from commefficient_tpu_torch.utils.config import Config

    spec = cs.CountSketch(**geometry)
    d = geometry["d"]
    k = min(k, d)
    comp = get_compressor(Config(mode="sketch", k=k, num_rows=geometry["r"],
                                 num_cols=geometry["c"],
                                 virtual_momentum=0.9, error_type="virtual"),
                          d=d, spec=spec)
    g = torch.Generator(device=dev).manual_seed(0)
    agg, err = (torch.randn(spec.table_shape, generator=g, device=dev)
                for _ in range(2))
    delta = torch.zeros(d, device=dev)
    delta[torch.randperm(d, generator=g, device=dev)[:k]] = torch.randn(
        k, generator=g, device=dev)
    params = torch.randn(d, generator=g, device=dev)
    cfg = SimpleNamespace(telemetry_level=level, error_type="virtual")

    def call():
        return round_diagnostics(
            cfg, comp, agg=agg, delta=delta, new_params=params,
            loss=torch.ones((), device=dev), lr=0.1, momentum=agg,
            error=err, extra=None, new_momentum=agg, new_error=err)

    diag = call()
    check(all(math.isfinite(float(v)) for v in diag.values()),
          f"diag cost: non-finite {diag}")
    # the call and its pieces: the update's squared norm, the params'
    # finiteness (the sentinel's one-read form and isfinite().all()), one
    # AMS estimate (a row-norm pass and K3), level 2's fidelity
    pieces = {"call": call,
              "update_sqnorm": lambda: sqnorm(delta),
              "all_finite_params": lambda: all_finite(params),
              "isfinite_all_params": lambda: torch.isfinite(params).all(),
              "ams_table": lambda: cs.table_sqnorm_estimate(agg)}
    if level >= 2:
        pieces["fidelity"] = lambda: comp.fidelity(
            agg=agg, delta=delta, momentum=agg, error=err, extra=None,
            new_momentum=agg, lr=0.1)
    out = {name: {"events_ms": cuda_ms(torch, fn, samples=11, calls=5),
                  "device_ms": device_ms(torch, fn)}
           for name, fn in pieces.items()}
    del agg, err, delta, params
    torch.cuda.empty_cache()
    return out


def telemetry_phase(torch, cs, kern, cv_train, gpt2_train, dataset_dir,
                    work, dev):
    """The round telemetry on the card. The main path's flags at
    ``--telemetry_level`` 0, 1 and 2 for TEL_ROUNDS rounds each (runner,
    deterministic cuDNN, the counters set to 0 just before each run and
    read just after): every leaf of the final state bit-equal across the
    levels, each level's launches exactly TEL_LAUNCHES a round (level 0:
    the main path's), round ms and peak memory; the ``diag/*`` values
    finite with ``diag/nonfinite`` 0; ``diag/update_norm`` of the last
    round equal to ``||p_2 - p_3||`` (p_2 from a 2-round level-2 run's
    checkpoint, bit-equal to the 3-round run's state there; rtol 1e-3, the
    f32 rounding of ``p - delta``); ``table_sqnorm_estimate`` of the
    level-1 run's tables through K3 exactly its plain network on the same
    row sums; the fidelity's route through K1 and K4's index form at
    ``(idx, val)`` of that update exactly the plain ``estimate_at_torch``
    route; the ledger's exactness by this phase's arithmetic; strict JSON
    in ``metrics.jsonl``. Then ``--chaos nan_client@2 --telemetry_level
    1``: ``DivergenceError`` at round 2 with ``flight_2.json``. Then
    GPT-2 BASELINE #4 at levels 0 and 1 for TEL_GPT2_ROUNDS rounds, and the
    device ms of one call of the diagnostics at both geometries. Every
    run on deterministic cuDNN. Returns the summed launch forms of the
    three ResNet-9 level runs."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _telemetry_phase(torch, cs, kern, cv_train, gpt2_train,
                                dataset_dir, work, dev)
    finally:
        torch.backends.cudnn.deterministic = prev


def _telemetry_phase(torch, cs, kern, cv_train, gpt2_train, dataset_dir,
                     work, dev):
    from commefficient_tpu_torch.ops.topk import compact_nonzero
    from commefficient_tpu_torch.telemetry import DivergenceError

    runs = {}
    for level in (0, 1, 2):
        gc.collect()  # the previous run's session, before the peak reset
        runs[level] = state_run(
            torch, kern, cv_train, dataset_dir, work, f"telemetry_l{level}",
            MAIN_ARGS + ["--telemetry_level", str(level), "--logdir",
                         os.path.join(work, f"tel_runs_l{level}")],
            rounds=TEL_ROUNDS)
    two = state_run(torch, kern, cv_train, dataset_dir, work,
                    "telemetry_l2_two",
                    MAIN_ARGS + ["--telemetry_level", "2", "--logdir",
                                 os.path.join(work, "tel_runs_two")],
                    rounds=2)
    bpr = runs[0]["out"]["bytes_per_round"]
    for level, run in runs.items():
        same, err = state_diff(torch, run["state"], runs[0]["state"],
                               GEOMETRY["d"])
        ln = run["launches"]
        metrics = read_metrics(run["out"]["logdir"])
        diag = {k: v for k, v in metrics.items() if k.startswith("diag/")}
        last = {k: v[TEL_ROUNDS - 1] for k, v in diag.items()}
        phase("telemetry", level=level, leaves_bit_equal_level0=same,
              round_ms=run["round_ms"], max_memory_allocated=run["peak"],
              launches=json.dumps({k: v for k, v in ln.items() if v}),
              last_round_diag=json.dumps(last))
        check(same, f"telemetry level {level}: state differs from level 0 "
                    f"by {err}")
        want = {w: n * TEL_ROUNDS for w, n in TEL_LAUNCHES[level].items()}
        got = {w: ln[w] for w in want}
        check(got == want and ln["estimate_at_range"] == 0
              and ln["sketch_segment"] == 0,
              f"telemetry level {level}: launches {ln}, expected {want}")
        check(all(set(v) == set(range(TEL_ROUNDS)) for v in diag.values()),
              f"telemetry level {level}: diag steps")
        want_keys = set() if level == 0 else {
            "diag/grad_norm", "diag/update_norm", "diag/ef_residual_norm",
            "diag/ef_residual_max", "diag/nonfinite"} | (
            {"diag/sketch_est_rel_err"} if level == 2 else set())
        check(set(diag) == want_keys, f"telemetry level {level}: {diag}")
        check(all(isinstance(x, float) and math.isfinite(x)
                  for v in diag.values() for x in v.values()),
              f"telemetry level {level}: a diag value is not finite")
        check(all(x == 0.0 for x in diag.get("diag/nonfinite", {}).values()),
              f"telemetry level {level}: the sentinel fired")
        if level == 0:
            check(not os.path.exists(os.path.join(
                run["out"]["logdir"], "comm_ledger.json")),
                "telemetry level 0 wrote a ledger")
            continue
        with open(os.path.join(run["out"]["logdir"],
                               "comm_ledger.json")) as f:
            led = json.load(f)
        check(led["bytes_per_round"] == bpr and led["rounds"] == TEL_ROUNDS
              and led["cum_up_bytes"] == TEL_ROUNDS * bpr["upload_bytes"]
              and led["cum_down_bytes"] == TEL_ROUNDS * bpr["download_bytes"]
              and led["cum_bytes"] == led["cum_up_bytes"]
              + led["cum_down_bytes"], f"telemetry ledger: {led}")
        check(metrics["comm/cum_bytes"][TEL_ROUNDS - 1] == led["cum_bytes"],
              "telemetry: comm/cum_bytes disagrees with the ledger")

    # the last round's update norm against the saved params
    p3 = runs[2]["state"]["params_vec"].to(dev)
    p2 = two["state"]["params_vec"].to(dev)
    # the 2-round run is the 3-round run's first two rounds: its drained
    # scalars are equal, bit for bit
    two_diag = read_metrics(two["out"]["logdir"])
    three_diag = read_metrics(runs[2]["out"]["logdir"])
    check(all(two_diag[k] == {s: v for s, v in three_diag[k].items()
                              if s < 2}
              for k in two_diag if k.startswith("diag/")),
          "telemetry: the 2-round run's diag differs from the 3-round's")
    delta = p2 - p3
    moved = float(torch.linalg.vector_norm(delta.double()))
    upd = {lv: read_metrics(runs[lv]["out"]["logdir"])["diag/update_norm"][
        TEL_ROUNDS - 1] for lv in (1, 2)}
    check(all(math.isclose(u, moved, rel_tol=1e-3) for u in upd.values()),
          f"telemetry: update_norm {upd} against ||p_2 - p_3|| {moved}")
    # K3 on the level-1 run's tables against its plain network
    spec = cs.CountSketch(**GEOMETRY)
    k3 = {}
    for leaf in ("momentum", "error"):
        table = runs[1]["state"][leaf].to(dev)
        rowsq = torch.linalg.vector_norm(table, dim=1,
                                         dtype=torch.float32).square()
        x = rowsq[:, None].contiguous()
        got, want = kern.median_rows(x), kern.median_rows_torch(x)
        check(torch.equal(got, want), f"telemetry: K3 on the {leaf} table")
        est = cs.table_sqnorm_estimate(table)
        ref = float(torch.median(rowsq.cpu()))  # odd r: the middle value
        check(float(est) == float(want[0]) and math.isclose(
            float(est), ref, rel_tol=1e-6), f"telemetry: AMS of {leaf}")
        k3[leaf] = float(est)
    # the level-2 fidelity's route through K1 and K4's index form
    idx, val = compact_nonzero(delta, 50_000)
    table = cs.sketch_sparse(spec, idx, val)
    est_k = kern.estimate_at(spec, table, idx)
    est_p = kern.estimate_at_torch(spec, table, idx)
    live = val != 0

    def rel(est):
        num = torch.linalg.vector_norm(torch.where(live, est - val, 0.0))
        return float(num / torch.clamp(torch.linalg.vector_norm(val),
                                       min=1e-30))

    rel_k, rel_p = rel(est_k), rel(est_p)
    fid = read_metrics(runs[2]["out"]["logdir"])["diag/sketch_est_rel_err"]
    phase("telemetry_values", update_norm_last=json.dumps(upd),
          params_moved_last=moved, table_sqnorm_estimate=json.dumps(k3),
          fidelity_nnz=int(live.sum()), fidelity_kernel=rel_k,
          fidelity_plain=rel_p, fidelity_metrics=json.dumps(fid))
    check(torch.equal(est_k, est_p) and rel_k == rel_p,
          "telemetry: K4's index form differs from its plain route")

    # the sentinel's one-read finiteness on the card: one bad element of a
    # [D] vector at a random place, against isfinite().all()
    from commefficient_tpu_torch.telemetry.diagnostics import all_finite

    v = torch.randn(GEOMETRY["d"], device=dev)
    flags = [bool(all_finite(v))]
    for bad in (float("nan"), float("inf"), -float("inf")):
        w = v.clone()
        w[int(torch.randint(GEOMETRY["d"], ()))] = bad
        flags.append(bool(all_finite(w)) == bool(torch.isfinite(w).all()))
    check(flags == [True] * 4, f"telemetry: all_finite on the card {flags}")
    del v, w

    # divergence on the card
    div = os.path.join(work, "tel_runs_div")
    kern.reset_launch_counts()
    caught = None
    try:
        cv_train.main(MAIN_ARGS + ["--chaos", "nan_client@2",
                                   "--telemetry_level", "1", "--logdir", div,
                                   "--max_rounds", str(TEL_ROUNDS),
                                   "--dataset_dir", dataset_dir])
    except DivergenceError as e:
        caught = e
    (run_dir,) = os.listdir(div)
    run_dir = os.path.join(div, run_dir)
    have = sorted(os.listdir(run_dir))
    phase("telemetry_divergence", step=getattr(caught, "step", None),
          path=os.path.basename(getattr(caught, "path", "") or ""),
          files=json.dumps(have))
    check(caught is not None and caught.step == 2,
          f"telemetry divergence: {caught!r}")
    check(caught.path == os.path.join(run_dir, "flight_2.json")
          and "comm_ledger.json" in have, f"telemetry divergence: {have}")
    with open(caught.path) as f:
        flight = json.load(f, parse_constant=_no_bare_constant)
    check([r["step"] for r in flight["records"]] == [0, 1, 2]
          and flight["records"][2]["scalars"]["diag/nonfinite"] == 1.0,
          "telemetry divergence: flight records")

    # GPT-2 BASELINE #4 at levels 0 and 1, and the diagnostics' cost
    gpt2 = {}
    for level in (0, 1):
        gc.collect()  # the previous run's session, before the peak reset
        kern.reset_launch_counts()
        out, peak, before = _peak_run(torch, lambda: gpt2_train.main(
            GPT2_ARGS + ["--max_rounds", str(TEL_GPT2_ROUNDS),
                         "--telemetry_level", str(level), "--logdir",
                         os.path.join(work, f"tel_gpt2_l{level}"),
                         "--dataset_dir", dataset_dir]))
        ln = kern.launch_counts()
        diag = {k: v for k, v in read_metrics(out["logdir"]).items()
                if k.startswith("diag/")}
        gpt2[level] = [round(h["ms"], 3) for h in out["history"]]
        phase("telemetry_gpt2", level=level, round_ms=gpt2[level],
              max_memory_allocated=peak, allocated_before=before,
              launches=json.dumps({k: v for k, v in ln.items() if v}),
              diag_last=json.dumps({k: v[TEL_GPT2_ROUNDS - 1]
                                    for k, v in diag.items()}))
        check(all(math.isfinite(h["loss"]) for h in out["history"]),
              "telemetry gpt2: loss not finite")
        check(ln["median_rows"] == (2 * TEL_GPT2_ROUNDS if level else 0)
              and ln["estimate_at"] == 0, f"telemetry gpt2: launches {ln}")
        check(all(math.isfinite(x) for v in diag.values()
                  for x in v.values()), "telemetry gpt2: diag not finite")
    cost = {"resnet9_l1": diag_cost_ms(torch, cs, GEOMETRY, 50_000, 1, dev),
            "resnet9_l2": diag_cost_ms(torch, cs, GEOMETRY, 50_000, 2, dev),
            "gpt2_l1": diag_cost_ms(torch, cs, GPT2_GEOMETRY, 50_000, 1,
                                    dev)}
    phase("telemetry_cost", **{k: json.dumps(v) for k, v in cost.items()})
    return add_forms(*(run["forms"] for run in runs.values()))


SPAN_ROUNDS = 8  # rounds of each spans-phase run of the main path
SPAN_GPT2_ROUNDS = 3
SPAN_WINDOW = (4, 5)  # --profile_rounds, inclusive
# K1, K2 and K3 a round at level 1 (TEL_LAUNCHES[1]): the spans, the
# window and the audit launch nothing of their own
SPAN_LAUNCHES = dict(sketch_rows=2, estimate_median=1, median_rows=2)
K1_SYMBOL = "cs_sketch_tiles_kernel"


def _run_dir_files(logdir):
    """The run dir's reports, spans dump and window traces."""
    def load(name):
        path = os.path.join(logdir, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f, parse_constant=_no_bare_constant)

    spans = sorted(f for f in os.listdir(logdir) if f.startswith("spans_"))
    check(len(spans) == 1, f"{logdir}: spans dumps {spans}")
    window = os.path.join(logdir, "profile_rounds")
    traces = (sorted(os.path.join(window, f) for f in os.listdir(window)
                     if f.endswith(".pt.trace.json"))
              if os.path.isdir(window) else [])
    return dict(spans=load(spans[0]), run=load("run_report.json"),
                perf=load("perf_report.json"), traces=traces,
                metrics=read_metrics(logdir))


def check_spans_dump(name, dump, rounds, depth):
    """One ``round_dispatch`` a round, untagged at one card; at depth 2
    the prefetch spans (two a round) on the lane labelled
    ``round-prefetch``, none at depth 0."""
    evs = dump["traceEvents"]
    disp = [e["args"]["step"] for e in evs if e["name"] == "round_dispatch"]
    check(disp == list(range(rounds)), f"{name}: dispatch spans {disp}")
    check(not any(e["args"].get("collective") for e in evs
                  if e.get("ph") == "X"), f"{name}: a collective tag")
    lanes = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    pre = [e for e in evs if e["name"].startswith("prefetch_")]
    if depth:
        check(list(lanes.values()) == ["round-prefetch"]
              and {e["tid"] for e in pre} == set(lanes)
              and len(pre) == 2 * rounds, f"{name}: prefetch lane {lanes}")
    else:
        check(not lanes and not pre, f"{name}: prefetch spans at depth 0")


def check_reports(name, files, rounds):
    """``run_report.json``: every round analyzed, fractions summing to 1
    within 1e-9, each round's stages summing to its wall within 1e-6 ms;
    ``perf_report.json``: FLOPs and peak memory measured, no collective
    at one card; ``xla/exposed_collective_ms`` 0.0 every round."""
    run, perf = files["run"], files["perf"]
    check(run["rounds_analyzed"] == rounds,
          f"{name}: {run['rounds_analyzed']} rounds analyzed")
    frac = sum(b["fraction"] for b in run["stages"].values())
    check(abs(frac - 1.0) <= 1e-9, f"{name}: fractions sum to {frac}")
    for r in run["rounds"]:
        check(abs(sum(r["stages_ms"].values()) - r["wall_ms"]) <= 1e-6,
              f"{name}: round {r['step']} stages != wall")
    check(perf["cost"]["flops"] > 0
          and (perf["memory"]["peak_hbm_bytes"] or 0) > 0,
          f"{name}: {perf['cost']} {perf['memory']}")
    check(perf["collectives"]["ops"] == {}
          and perf["collectives"]["total_bytes"] == 0,
          f"{name}: collectives {perf['collectives']}")
    exposed = files["metrics"]["xla/exposed_collective_ms"]
    check(sorted(exposed) == list(range(rounds))
          and set(exposed.values()) == {0.0}, f"{name}: exposure {exposed}")


def window_k1_events(path):
    """K1's kernel events in one ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    return sum(1 for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and K1_SYMBOL in e.get("name", ""))


def span_cost_us(n: int = 20000) -> dict:
    """Host µs of one span (``span`` as the session records one, and
    ``span_at``), and of one round's ``trace/*`` scalars on a recorder
    holding 8 rounds of 6 spans each: medians of 5 timings of ``n`` calls
    (``trace_round_scalars``: ``n // 20``)."""
    import tempfile

    from commefficient_tpu_torch.telemetry import (
        PhaseSpans,
        trace_round_scalars,
    )

    with tempfile.TemporaryDirectory() as d:
        def timed(fn, calls):
            out = []
            for _ in range(5):
                sp = PhaseSpans(d)
                for s in range(8):
                    sp.step(s)
                    for name in ("data_load", "device_put", "fedsim_env",
                                 "round_dispatch", "prefetch_realize",
                                 "prefetch_stage"):
                        with sp.span(name, trace_id=f"r{s}"):
                            pass
                t = time.perf_counter()
                for i in range(calls):
                    fn(sp, i)
                out.append((time.perf_counter() - t) / calls * 1e6)
            return statistics.median(out)

        def one_span(sp, i):
            with sp.span("round_dispatch", trace_id="r7"):
                pass

        return {"span": timed(one_span, n),
                "span_at": timed(lambda sp, i: sp.span_at(
                    "data_load", 1.0, 2.0), n),
                "trace_round_scalars": timed(
                    lambda sp, i: trace_round_scalars(sp, 5), n // 20)}


def spans_phase(torch, kern, cv_train, gpt2_train, dataset_dir, work):
    """The host spans, the critical path, the run and perf reports and
    the ``--profile_rounds`` window on the card. The main path at
    ``--telemetry_level 1`` for SPAN_ROUNDS rounds at ``--pipeline_depth``
    0 and 2 with ``--profile_rounds 4-5``, and the same flags with
    ``--perf_audit false --run_report false`` (level 1 still records
    spans), each run on deterministic cuDNN with the counters set to 0
    just before and read just after: every leaf bit-equal across the runs
    of one depth; the spans dump, the reports and the exposure
    (``check_spans_dump``, ``check_reports``); the window's trace holding
    K1 exactly twice a window round; K1, K2 and K3 at SPAN_LAUNCHES a
    round. Then GPT-2 BASELINE #4 at level 1 for SPAN_GPT2_ROUNDS rounds
    (the same report checks, its launches). Prints the round ms with the
    reports on and off, each stage's p50, the critical stage, round 0's
    FLOPs and peak memory. Returns the summed launch forms."""
    t0 = time.perf_counter()
    win = f"{SPAN_WINDOW[0]}-{SPAN_WINDOW[1]}"
    n_win = SPAN_WINDOW[1] - SPAN_WINDOW[0] + 1
    forms, states = [], {}
    for depth in (0, 2):
        for mode, extra in (("on", []), ("off", ["--perf_audit", "false",
                                                 "--run_report", "false"])):
            name = f"spans_d{depth}_{mode}"
            gc.collect()
            run = state_run(
                torch, kern, cv_train, dataset_dir, work, name,
                MAIN_ARGS + ["--telemetry_level", "1", "--pipeline_depth",
                             str(depth), "--profile_rounds", win,
                             "--logdir", os.path.join(work, name)] + extra,
                rounds=SPAN_ROUNDS)
            forms.append(run["forms"])
            states[depth, mode] = run["state"]
            ln = run["launches"]
            want = {k: n * SPAN_ROUNDS for k, n in SPAN_LAUNCHES.items()}
            check({k: ln[k] for k in want} == want
                  and ln["estimate_at"] == ln["estimate_at_range"] == 0,
                  f"{name}: launches {ln}")
            files = _run_dir_files(run["out"]["logdir"])
            check_spans_dump(name, files["spans"], SPAN_ROUNDS, depth)
            k1 = [window_k1_events(p) for p in files["traces"]]
            check(k1 == [2 * n_win], f"{name}: window K1 events {k1}")
            fields = dict(depth=depth, reports=mode,
                          round_ms=run["round_ms"],
                          window_k1_events=k1[0])
            if mode == "on":
                check_reports(name, files, SPAN_ROUNDS)
                rep, perf = files["run"], files["perf"]
                fields.update(
                    critical_stage=rep["critical_stage"],
                    stage_p50_ms=json.dumps({
                        k: round(b["p50_ms"], 4)
                        for k, b in rep["stages"].items()}),
                    stage_fraction=json.dumps({
                        k: round(b["fraction"], 4)
                        for k, b in rep["stages"].items()}),
                    round0_flops=perf["cost"]["flops"],
                    round0_peak_bytes=perf["memory"]["peak_hbm_bytes"],
                    peak_flops=perf["predicted"]["peak_flops"],
                    device_kind=repr(perf["predicted"]["device_kind"]))
            else:
                check(files["run"] is None and files["perf"] is None,
                      f"{name}: a report written with it off")
            phase("spans", **fields)
        same, err = state_diff(torch, states[depth, "on"],
                               states[depth, "off"], GEOMETRY["d"])
        check(same, f"spans depth {depth}: leaves differ by {err}")
    across, _ = state_diff(torch, states[0, "on"], states[2, "on"],
                           GEOMETRY["d"])
    # GPT-2 BASELINE #4 at level 1
    gc.collect()
    kern.reset_launch_counts()
    out, peak, _ = _peak_run(torch, lambda: gpt2_train.main(
        GPT2_ARGS + ["--max_rounds", str(SPAN_GPT2_ROUNDS),
                     "--telemetry_level", "1", "--logdir",
                     os.path.join(work, "spans_gpt2"),
                     "--dataset_dir", dataset_dir]))
    ln, gforms = kern.launch_counts(), kern.form_counts()
    forms.append(gforms)
    want = {k: n * SPAN_GPT2_ROUNDS for k, n in SPAN_LAUNCHES.items()}
    check({k: ln[k] for k in want} == want, f"spans gpt2: launches {ln}")
    check(all(math.isfinite(h["loss"]) for h in out["history"]),
          "spans gpt2: loss not finite")
    files = _run_dir_files(out["logdir"])
    check_spans_dump("spans_gpt2", files["spans"], SPAN_GPT2_ROUNDS, 0)
    check_reports("spans_gpt2", files, SPAN_GPT2_ROUNDS)
    rep, perf = files["run"], files["perf"]
    phase("spans_gpt2", round_ms=[round(h["ms"], 3) for h in out["history"]],
          critical_stage=rep["critical_stage"],
          stage_p50_ms=json.dumps({k: round(b["p50_ms"], 4)
                                   for k, b in rep["stages"].items()}),
          round0_flops=perf["cost"]["flops"],
          round0_peak_bytes=perf["memory"]["peak_hbm_bytes"],
          max_memory_allocated=peak,
          launches=json.dumps({k: v for k, v in ln.items() if v}))
    phase("spans_cost", **{k: round(v, 3) for k, v in span_cost_us().items()})
    phase("spans_wall", leaves_bit_equal_depth0_depth2=across,
          wall_s=round(time.perf_counter() - t0, 3))
    return add_forms(*forms)


CTL_ROUNDS = 8  # rounds of each control-phase run
CTL_LADDER = "k=50000,25000;num_cols=500000,250000"
CTL_SCHEDULE = "0-2=0,3-5=1,6-=0"
CTL_SEQUENCE = [0, 0, 0, 1, 1, 1, 0, 0]  # the schedule's rung a round
CTL_FIXED = ["--telemetry_level", "1", "--control_policy", "fixed",
             "--ladder", CTL_LADDER, "--control_schedule", CTL_SCHEDULE]
CTL_RESUME_AT = 4
CTL_BUDGET_ROUNDS = 5  # the rounds the budget run can pay for
RUNG0_UPLOAD = 10_108_800  # the [5, 505,440] f32 table
CTL_COLS1 = 250_000  # rung 1's requested num_cols


class ControlProbe:
    """Inside ``with ControlProbe(torch):`` each sketch ``migrate_state``
    records its compressors, copies of its input tables, its output tables
    and CUDA events around the call, and each
    ``BudgetController.on_round_start`` its step, whether it switched, and
    its host microseconds. The probe adds no kernel launch."""

    def __init__(self, torch):
        from commefficient_tpu_torch.compress.sketch import SketchCompressor
        from commefficient_tpu_torch.control.controller import (
            BudgetController,
        )

        self.torch = torch
        self.classes = (SketchCompressor, BudgetController)
        self.migrations, self.starts = [], []

    def __enter__(self):
        torch, probe = self.torch, self
        comp_cls, ctrl_cls = self.classes
        self.saved = migrate, start = (comp_cls.migrate_state,
                                       ctrl_cls.on_round_start)

        def migrate_state(comp, new, momentum, error, extra):
            ins = [None if t is None else t.clone()
                   for t in (momentum, error)]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = migrate(comp, new, momentum, error, extra)
            b.record()
            probe.migrations.append(dict(old=comp, new=new, ins=ins,
                                         outs=list(out[:2]), events=(a, b)))
            return out

        def on_round_start(ctrl, step, fs_stats=None):
            n = ctrl.switches
            t0 = time.perf_counter()
            rung = start(ctrl, step, fs_stats)
            probe.starts.append((step, ctrl.switches != n,
                                 (time.perf_counter() - t0) * 1e6))
            return rung

        comp_cls.migrate_state = migrate_state
        ctrl_cls.on_round_start = on_round_start
        return self

    def __exit__(self, *exc):
        comp_cls, ctrl_cls = self.classes
        comp_cls.migrate_state, ctrl_cls.on_round_start = self.saved

    def quiet_us(self):
        """The host us of each ``on_round_start`` that did not switch."""
        return [us for _, switched, us in self.starts if not switched]


def hold_migration(torch, cs, kern, rec):
    """One recorded ``num_cols`` migration against its plain version on
    the same card tensors: K2's estimate of each input table exactly
    ``estimate_median_torch``'s, and the output table within K1's
    ``1e-5 * max|table|`` of the plain route (the same top-k and
    compaction, ``sketch_rows_torch`` at the new spec). Returns (the
    largest K1 error over the tables, the event ms, the steady ms of the
    whole migration)."""
    from commefficient_tpu_torch.ops.topk import (
        compact_nonzero,
        topk_threshold_dense,
    )

    old, new = rec["old"], rec["new"]
    k = old.cfg.k
    select = (topk_threshold_dense if old.cfg.topk_method == "threshold"
              else cs.topk_scatter)
    err = 0.0
    for t_in, t_out in zip(rec["ins"], rec["outs"]):
        if t_in is None:
            continue
        e_k = kern.estimate_median(old.spec, t_in, old.spec.dtype)
        e_p = kern.estimate_median_torch(old.spec, t_in, old.spec.dtype)
        check(torch.equal(e_k, e_p), "control: the migration's K2 differs "
              "from its plain version")
        idx, val = compact_nonzero(select(e_p, k), k)
        v = torch.zeros(old.spec.d, dtype=torch.float32, device=t_in.device)
        v.index_add_(0, idx, val)
        t_p = kern.sketch_rows_torch(new.spec, cs._scramble(new.spec, v),
                                     torch.float32, new.spec.table_dtype)
        check(t_out.shape == t_p.shape == new.spec.table_shape,
              f"control: migrated table {tuple(t_out.shape)}")
        e = float((t_out.float() - t_p.float()).abs().max())
        tol = 1e-5 * max(1.0, float(t_p.float().abs().max()))
        check(e <= tol, f"control: the migration's K1 table is {e} from "
              f"its plain version (> {tol})")
        err = max(err, e)
    a, b = rec["events"]
    b.synchronize()
    m, e = rec["ins"]
    steady = cuda_ms(torch, lambda: old.migrate_state(new, m, e, None),
                     samples=5, calls=2)
    return err, a.elapsed_time(b), steady


def rung_trail(logdir):
    """``control/rung`` of each round of a run dir, in step order."""
    rungs = read_metrics(logdir).get("control/rung", {})
    return [int(rungs[s]) for s in sorted(rungs)]


def control_phase(torch, cs, kern, cv_train, dataset_dir, work):
    """The control plane on the card (``control/``). The main path's flags
    at ``--telemetry_level 1`` for CTL_ROUNDS rounds on deterministic
    cuDNN, each run through ``cv_train.main`` with the counters set to 0
    just before it and read just after:

    1. the control-free twin, then ``--control_policy fixed --ladder
       CTL_LADDER --control_schedule CTL_SCHEDULE``: 2 switches, the rung
       sequence CTL_SEQUENCE, the ledger's per-rung rounds (5 and 3) and
       exact per-rung bytes (rung 0 uploads RUNG0_UPLOAD B a client, rung
       1 ``4 * 5 * c_actual(250,000)``), K1 and K2 each 4 more launches
       than the twin (a ``num_cols`` switch decodes each of the 2 tables
       through K2 and re-sketches it through K1) and K3 as many; each
       migration held against its plain version on the tensors of the
       switch (``hold_migration``), its ms by CUDA events in the run and
       steady, and the host us of ``on_round_start`` on the rounds without
       a switch;
    2. the same at ``--pipeline_depth 2``: every leaf bit-equal to run 1,
       a quiesce a switch;
    3. the same checkpointed at round CTL_RESUME_AT and resumed: the same
       rung sequence, the same controller blob and every leaf bit-equal;
    4. ``--control_policy budget_pacing`` with the budget of 5.5 rounds at
       rung 1: the pacing picks rung 1 from round 0, and round
       CTL_BUDGET_ROUNDS raises ``BudgetExhaustedError`` before it runs;
       the ledger bills CTL_BUDGET_ROUNDS rounds, and the flight dump's
       ``controller.policy`` is ``budget_pacing``;
    5. ``--control_policy ef_feedback`` on the ladder: starts at rung 1,
       finite losses, and K1 and K2 at the twin's launches plus 2 a
       switch.

    Returns the summed launch forms of the phase's runs."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _control_phase(torch, cs, kern, cv_train, dataset_dir, work)
    finally:
        torch.backends.cudnn.deterministic = prev


def _control_phase(torch, cs, kern, cv_train, dataset_dir, work):
    from commefficient_tpu_torch.control import BudgetExhaustedError

    t0 = time.perf_counter()
    base = MAIN_ARGS + ["--telemetry_level", "1"]
    c1 = cs.CountSketch(**{**GEOMETRY, "c": CTL_COLS1}).c_actual
    up1 = 4 * 5 * c1
    down = 4 * GEOMETRY["d"]
    forms = []

    def run(name, args, rounds=CTL_ROUNDS):
        gc.collect()
        with ControlProbe(torch) as probe:
            r = state_run(torch, kern, cv_train, dataset_dir, work, name,
                          args + ["--logdir", os.path.join(work, name)],
                          rounds=rounds)
        forms.append(r["forms"])
        return r, probe

    twin, _ = run("control_twin", base)
    fixed, probe = run("control_fixed", base + CTL_FIXED)
    ln, ln0 = fixed["launches"], twin["launches"]
    seq = rung_trail(fixed["out"]["logdir"])
    with open(os.path.join(fixed["out"]["logdir"], "comm_ledger.json")) as f:
        led = json.load(f)
    holds = [hold_migration(torch, cs, kern, rec)
             for rec in probe.migrations]
    quiet = probe.quiet_us()
    phase("control", run="fixed", c_actual_rung1=c1,
          rung_sequence=json.dumps(seq),
          switches=fixed["out"]["control"]["switches"],
          rung_rounds=json.dumps([r["rounds"] for r in led["rungs"]]),
          rung_upload_bytes=json.dumps([r["bytes_per_round"]["upload_bytes"]
                                        for r in led["rungs"]]),
          cum_bytes=led["cum_bytes"],
          launches=json.dumps({k: v for k, v in ln.items() if v}),
          twin_launches=json.dumps({k: v for k, v in ln0.items() if v}),
          migration_k1_max_abs_err=json.dumps([h[0] for h in holds]),
          migration_ms_in_run=json.dumps([round(h[1], 4) for h in holds]),
          migration_ms_steady=json.dumps([round(h[2], 4) for h in holds]),
          on_round_start_us_no_switch=json.dumps([round(u, 2)
                                                  for u in quiet]),
          on_round_start_us_no_switch_median=round(
              statistics.median(quiet), 2),
          round_ms=fixed["round_ms"], twin_round_ms=twin["round_ms"])
    check(seq == CTL_SEQUENCE, f"control fixed: rung sequence {seq}")
    check(fixed["out"]["control"]["switches"] == 2 == len(holds),
          f"control fixed: {fixed['out']['control']} {len(holds)} migrations")
    want_rungs = [{"bytes_per_round": {
        "upload_floats": up // 4, "download_floats": GEOMETRY["d"],
        "upload_bytes": up, "download_bytes": down}, "rounds": n}
        for up, n in ((RUNG0_UPLOAD, 5), (up1, 3))]
    check(led["rungs"] == want_rungs and led["rounds"] == CTL_ROUNDS
          and led["cum_up_bytes"] == 5 * RUNG0_UPLOAD + 3 * up1
          and led["cum_down_bytes"] == CTL_ROUNDS * down,
          f"control fixed: ledger {led}")
    check(ln["sketch_rows"] == ln0["sketch_rows"] + 4
          and ln["estimate_median"] == ln0["estimate_median"] + 4
          and ln["median_rows"] == ln0["median_rows"]
          and ln["estimate_at"] == ln["estimate_at_range"] == 0,
          f"control fixed: launches {ln} against the twin's {ln0}")

    deep, deep_probe = run("control_depth2",
                           base + CTL_FIXED + ["--pipeline_depth", "2"])
    same, err = state_diff(torch, deep["state"], fixed["state"],
                           GEOMETRY["d"])
    quiesces = deep["out"]["pipeline_stats"]["quiesces"]
    phase("control", run="depth2", leaves_bit_equal=same, quiesces=quiesces,
          rung_sequence=json.dumps(rung_trail(deep["out"]["logdir"])),
          round_ms=deep["round_ms"])
    check(same, f"control depth 2: leaves differ from depth 0 by {err}")
    check(quiesces == deep["out"]["control"]["switches"] == 2,
          f"control depth 2: {quiesces} quiesces")

    # checkpointed at CTL_RESUME_AT and resumed into a fresh session
    ck = os.path.join(work, "control_resume")
    flags = base + CTL_FIXED + ["--dataset_dir", dataset_dir,
                                "--checkpoint_dir", ck, "--checkpoint_every",
                                str(CTL_RESUME_AT)]
    gc.collect()
    kern.reset_launch_counts()
    first = cv_train.main(flags + ["--max_rounds", str(CTL_RESUME_AT),
                                   "--logdir", ck + "_a"])
    second = cv_train.main(flags + ["--max_rounds", str(CTL_ROUNDS),
                                    "--resume", "true", "--logdir",
                                    ck + "_b"])
    forms.append(kern.form_counts())
    blobs = [torch.load(os.path.join(d, f"step_{CTL_ROUNDS}.pt"),
                        weights_only=True)["control"]
             for d in (os.path.join(work, "control_fixed"), ck)]
    resumed = load_state(os.path.join(ck, f"step_{CTL_ROUNDS}.pt"))
    same, err = state_diff(torch, resumed, fixed["state"], GEOMETRY["d"])
    seq_r = rung_trail(first["logdir"]) + rung_trail(second["logdir"])
    phase("control", run="resume", resumed_from=second["checkpoint"][
        "resumed_from"], rung_sequence=json.dumps(seq_r),
        blob=json.dumps(blobs[1].tolist()), blob_equal=torch.equal(*blobs),
        leaves_bit_equal=same)
    check(second["checkpoint"]["resumed_from"] == CTL_RESUME_AT
          and seq_r == CTL_SEQUENCE, f"control resume: sequence {seq_r}")
    check(torch.equal(*blobs), f"control resume: blobs {blobs}")
    check(same, f"control resume: leaves differ by {err}")

    # the budget of 5.5 rounds at rung 1
    cost1 = up1 + down
    budget_mb = (CTL_BUDGET_ROUNDS + 0.5) * cost1 / 1e6
    logdir = os.path.join(work, "control_budget")
    gc.collect()
    kern.reset_launch_counts()
    caught = None
    try:
        cv_train.main(base + ["--control_policy", "budget_pacing", "--ladder",
                              CTL_LADDER, "--budget_mb", repr(budget_mb),
                              "--max_rounds", str(CTL_ROUNDS),
                              "--dataset_dir", dataset_dir, "--logdir",
                              logdir])
    except BudgetExhaustedError as e:
        caught = e
    bl = kern.launch_counts()
    forms.append(kern.form_counts())
    (run_dir,) = os.listdir(logdir)
    run_dir = os.path.join(logdir, run_dir)
    with open(os.path.join(run_dir, "comm_ledger.json")) as f:
        bled = json.load(f)
    dumps = sorted(f for f in os.listdir(run_dir) if f.startswith("flight_"))
    with open(os.path.join(run_dir, dumps[-1])) as f:
        dump = json.load(f, parse_constant=_no_bare_constant)
    phase("control", run="budget_pacing", budget_mb=budget_mb,
          raised_at=getattr(caught, "step", None),
          spent_bytes=getattr(caught, "spent_bytes", None),
          ledger_rounds=bled["rounds"], ledger_cum_bytes=bled["cum_bytes"],
          rung_rounds=json.dumps([r["rounds"] for r in bled["rungs"]]),
          flight=dumps[-1], flight_controller=json.dumps(dump["controller"]),
          launches=json.dumps({k: v for k, v in bl.items() if v}))
    check(caught is not None and caught.step == CTL_BUDGET_ROUNDS
          and caught.spent_bytes == CTL_BUDGET_ROUNDS * cost1,
          f"control budget: {caught!r}")
    check(bled["rounds"] == CTL_BUDGET_ROUNDS
          and bled["cum_bytes"] == CTL_BUDGET_ROUNDS * cost1
          and [r["rounds"] for r in bled["rungs"]] == [0, CTL_BUDGET_ROUNDS],
          f"control budget: ledger {bled}")
    check(dump["controller"]["policy"] == "budget_pacing"
          and dump["controller"]["switches"] == 1,
          f"control budget: flight {dump['controller']}")
    # one switch (rung 0 -> 1 at round 0, zero tables) and the rounds run
    check(bl["sketch_rows"] == 2 * CTL_BUDGET_ROUNDS + 2
          and bl["estimate_median"] == CTL_BUDGET_ROUNDS + 2,
          f"control budget: launches {bl}")

    ef, _ = run("control_ef", base + ["--control_policy", "ef_feedback",
                                      "--ladder", CTL_LADDER])
    eln, n_sw = ef["launches"], ef["out"]["control"]["switches"]
    seq_e = rung_trail(ef["out"]["logdir"])
    phase("control", run="ef_feedback", rung_sequence=json.dumps(seq_e),
          switches=n_sw, losses=[round(h["loss"], 5)
                                 for h in ef["out"]["history"]],
          launches=json.dumps({k: v for k, v in eln.items() if v}))
    check(seq_e[0] == 1, f"control ef_feedback: starts at rung {seq_e[0]}")
    check(eln["sketch_rows"] == ln0["sketch_rows"] + 2 * n_sw
          and eln["estimate_median"] == ln0["estimate_median"] + 2 * n_sw,
          f"control ef_feedback: launches {eln}, {n_sw} switches")
    phase("control_wall", wall_s=round(time.perf_counter() - t0, 3))
    return add_forms(*forms)


RES_ROUNDS = 8  # rounds of each resilience-phase run
RES_BASE = ["--telemetry_level", "1", "--availability", "bernoulli",
            "--dropout_prob", "0.25"]
RES_NAN = ["--chaos", "nan_client@1:rounds=5-5", "--snapshot_every", "4"]
RES_ROLLBACK = 4  # the round-8 drain finds round 5; the round-4 snapshot
RES_REPLAYED = RES_ROUNDS - RES_ROLLBACK  # rounds 4-7 run twice
RES_LADDER = CTL_LADDER
RES_PREEMPT_AT = 4  # preempt@4: rounds 0-4 run, a checkpoint at 5
# C.1's ladder: ten num_cols rungs from 500,000 down to 250,000
C1_COLS = [500_000 - i * 250_000 // 9 for i in range(10)]
RES_COMPARED = ("train/loss", "diag/", "fedsim/", "comm/")


class ResilienceProbe:
    """Inside ``with ResilienceProbe(torch, kern):`` each vault capture
    records its ms and bytes, each restore its ms (the device drained
    after it), and each recovery the plan builds and the time at its
    start, at its return and at the next round's dispatch (re-entry). The
    probe adds no kernel launch."""

    def __init__(self, torch, kern):
        from commefficient_tpu_torch.parallel import FederatedSession
        from commefficient_tpu_torch.resilience import (
            RecoveryManager,
            RollbackVault,
        )

        self.torch, self.kern = torch, kern
        self.targets = ((RollbackVault, "snapshot"),
                        (RollbackVault, "restore"),
                        (RecoveryManager, "on_divergence"),
                        (FederatedSession, "_round"))
        self.snapshots, self.restores, self.recoveries = [], [], []

    def __enter__(self):
        torch, kern, probe = self.torch, self.kern, self
        self.saved = [getattr(c, n) for c, n in self.targets]
        snapshot, restore, on_divergence, round_ = self.saved

        def snap(vault, *a, **k):
            t0 = time.perf_counter()
            out = snapshot(vault, *a, **k)
            probe.snapshots.append(((time.perf_counter() - t0) * 1e3,
                                    out.nbytes))
            return out

        def rest(vault, *a, **k):
            t0 = time.perf_counter()
            out = restore(vault, *a, **k)
            torch.cuda.synchronize()
            probe.restores.append((time.perf_counter() - t0) * 1e3)
            return out

        def recover(manager, exc):
            rec = dict(t0=time.perf_counter(), builds0=kern.plan_builds(),
                       first_bad=exc.step)
            probe.recoveries.append(rec)
            out = on_divergence(manager, exc)
            torch.cuda.synchronize()
            rec.update(t1=time.perf_counter(), builds1=kern.plan_builds(),
                       rollback=out)
            return out

        def dispatch(sess, *a, **k):
            rec = probe.recoveries[-1] if probe.recoveries else None
            if rec is not None and "t1" in rec and "reentry" not in rec:
                rec["reentry"] = time.perf_counter()
            return round_(sess, *a, **k)

        for (cls, name), fn in zip(self.targets,
                                   (snap, rest, recover, dispatch)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in zip(self.targets, self.saved):
            setattr(cls, name, fn)

    def recovery_ms(self):
        """Each recovery's ms from the caught error to the dispatch of
        the first replayed round."""
        return [(r["reentry"] - r["t0"]) * 1e3 for r in self.recoveries
                if "reentry" in r]


def deduped(logdir, prefixes=RES_COMPARED):
    """``{(name, step): value}`` of a run dir's scalars under ``prefixes``,
    the last record of a (name, step) kept: a replayed round is logged
    twice, and the healed value is the one that stands."""
    return {(name, step): v for name, steps in read_metrics(logdir).items()
            if name.startswith(prefixes) for step, v in steps.items()}


def last_scalar(logdir, name):
    steps = read_metrics(logdir).get(name, {})
    return steps[max(steps)] if steps else None


def switch_probe(torch, kern, cv_train, dataset_dir, cols, order,
                 rounds=2):
    """A full-width main-path session on a ``num_cols`` ladder of
    ``cols``, prewarmed by its controller, trained ``rounds`` rounds at
    rung 0, then switched through ``order`` (``set_active_rung``, each
    table decoded by K2 and re-sketched by K1): the prewarm's ms and
    launches, each switch's host ms (the device drained before and
    after), and the plan builds over the switches."""
    from commefficient_tpu_torch.control import build_controller
    from commefficient_tpu_torch.data import FedSampler
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.utils.config import parse_args

    cfg = parse_args(MAIN_ARGS + [
        "--telemetry_level", "1", "--control_policy", "fixed",
        "--control_schedule", "0-=0", "--dataset_dir", dataset_dir,
        "--ladder", "num_cols=" + ",".join(str(c) for c in cols)])
    train, _, _, params, loss_fn, augment = cv_train.build_model_and_data(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the envelope, rung by rung
        sess = FederatedSession(cfg, params, loss_fn)
    ctrl = build_controller(cfg, sess, num_rounds=rounds)
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    ctrl.prewarm()
    torch.cuda.synchronize()
    prewarm_ms = (time.perf_counter() - t0) * 1e3
    prewarm_launches = sum(kern.launch_counts().values())
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size,
                         seed=cfg.seed, augment=augment)
    for s in range(rounds):
        ids, batch = sampler.sample_round(s)
        sess.train_round(ids, batch, 0.1)
    torch.cuda.synchronize()
    builds = kern.plan_builds()
    kern.reset_launch_counts()
    ms = []
    for i in order:
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.set_active_rung(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(prewarm_ms=prewarm_ms, prewarm_launches=prewarm_launches,
                switch_ms=ms, plan_builds=kern.plan_builds() - builds,
                launches=kern.launch_counts(), rung=sess.active_rung)


# the fresh process's switches: 0 -> 1, then three times 1 -> 0 -> 1
FRESH_ORDER = [1, 0, 1, 0, 1, 0, 1]
FRESH_COLS = [500_000, 250_000]


def fresh_switch_main() -> int:
    """``chip_smoke.py --fresh-switch``: ``switch_probe`` in this fresh
    process over FRESH_COLS and FRESH_ORDER; prints one JSON line."""
    import torch

    sys.path.insert(0, ROOT)
    from commefficient_tpu_torch.ops.cuda import build
    from commefficient_tpu_torch.ops.cuda import countsketch as kern
    from commefficient_tpu_torch.train import cv_train

    from commefficient_tpu_torch.data import FedDataset
    from commefficient_tpu_torch.data.cifar import _synthetic_cifar

    def small_cifar(dataset_dir, *, num_clients, iid=True, seed=42,
                    synthetic_variant="flat"):
        # the switches do not read the data: 2,048 stand-in images spare
        # the process the draw of 50,000
        train, test = _synthetic_cifar(10, n_train=2048, n_test=64)
        return (FedDataset(train, num_clients, iid=iid, seed=seed),
                FedDataset(test, 1, iid=True, seed=seed), False)

    build.load_library()
    cv_train.load_fed_cifar10 = small_cifar
    out = switch_probe(torch, kern, cv_train, "", FRESH_COLS, FRESH_ORDER)
    print(json.dumps(out))
    return 0


def resilience_phase(torch, cs, kern, cv_train, dataset_dir, work):
    """Self-healing training (``resilience/``) on the card: the main path
    at level 1 with ``--availability bernoulli --dropout_prob 0.25`` for
    RES_ROUNDS rounds on deterministic cuDNN, each run through
    ``cv_train.main`` with the counters set to 0 just before it and read
    just after:

    (a) the twin; (b) ``--chaos nan_client@1:rounds=5-5 --recover_policy
    retry --snapshot_every 4``: every leaf and every deduped ``train/loss``,
    ``diag/*``, ``fedsim/*`` and ``comm/*`` scalar bit-equal to (a), one
    recovery rolled back to round 4, ``flight_5.json`` and
    ``flight_5_recovery.json``, K1, K2 and K3 at (a)'s launches plus the
    RES_REPLAYED replayed rounds'; (c) (b) at ``--pipeline_depth 2``: the
    leaves bit-equal to (a), one restart; (d) ``demote`` on the ladder
    RES_LADDER held on rung 0: the run ends on rung 1 with one demotion,
    the demotion's migration held against its plain version, no plan
    built from the recovery on; (e) ``skip_clients``: the suspect
    blacklisted, the ledger's live-byte invariant; (f) ``preempt@4`` with
    checkpoints every 2 rounds: ``SystemExit(75)`` from a saved
    ``PreemptShutdown`` at round 5, the resumed run's leaves bit-equal to
    (a), and one ``cv_train`` subprocess exiting 75; (g) C.1: a 10-rung
    ``num_cols`` ladder prewarmed, a switch to every rung with no plan
    built, and in a fresh process the first switch within 2x of a steady
    one. Prints the snapshot's capture ms and bytes, the restore's ms and
    the recovery's ms (medians). Returns the summed launch forms."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _resilience_phase(torch, cs, kern, cv_train, dataset_dir,
                                 work)
    finally:
        torch.backends.cudnn.deterministic = prev


def _resilience_phase(torch, cs, kern, cv_train, dataset_dir, work):
    from commefficient_tpu_torch.resilience import (
        EXIT_PREEMPTED,
        PreemptShutdown,
    )

    t0 = time.perf_counter()
    base = MAIN_ARGS + RES_BASE
    forms = []
    probe = ResilienceProbe(torch, kern)

    def run(name, args, depth_probe=False):
        gc.collect()
        t = time.perf_counter()
        with ControlProbe(torch) as ctl, probe:
            r = state_run(torch, kern, cv_train, dataset_dir, work, name,
                          args + ["--logdir", os.path.join(work, name)],
                          rounds=RES_ROUNDS)
        forms.append(r["forms"])
        r["wall_s"] = round(time.perf_counter() - t, 3)
        r["migrations"] = ctl.migrations
        return r

    def launches(r):
        return json.dumps({k: v for k, v in r["launches"].items() if v})

    twin = run("res_twin", base)
    a_log = twin["out"]["logdir"]
    retry = run("res_retry", base + RES_NAN + ["--recover_policy", "retry"])
    b_log = retry["out"]["logdir"]
    same, err = state_diff(torch, retry["state"], twin["state"],
                           GEOMETRY["d"])
    sa, sb = deduped(a_log), deduped(b_log)
    ln, ln0 = retry["launches"], twin["launches"]
    files = sorted(f for f in os.listdir(b_log) if f.startswith("flight_"))
    phase("resilience", run="retry", leaves_bit_equal=same,
          scalars_bit_equal=sa == sb, scalars_compared=len(sa),
          recoveries=last_scalar(b_log, "resilience/recoveries"),
          rollback_round=last_scalar(b_log, "resilience/rollback_round"),
          flight=json.dumps(files), launches=launches(retry),
          twin_launches=launches(twin), wall_s=retry["wall_s"],
          twin_wall_s=twin["wall_s"])
    check(same, f"resilience retry: leaves differ from the twin by {err}")
    check(sa == sb, "resilience retry: scalars differ from the twin at "
          f"{sorted(k for k in sa if sa[k] != sb.get(k))[:5]}")
    check(last_scalar(b_log, "resilience/recoveries") == 1.0
          and last_scalar(b_log, "resilience/rollback_round")
          == RES_ROLLBACK, "resilience retry: recoveries/rollback")
    check({"flight_5.json", "flight_5_recovery.json"} <= set(files),
          f"resilience retry: flight dumps {files}")
    check(ln["sketch_rows"] == ln0["sketch_rows"] + 2 * RES_REPLAYED
          and ln["estimate_median"] == ln0["estimate_median"] + RES_REPLAYED
          and ln["median_rows"] == ln0["median_rows"] + 2 * RES_REPLAYED,
          f"resilience retry: launches {ln} against the twin's {ln0}")

    deep = run("res_retry_depth2", base + RES_NAN + [
        "--recover_policy", "retry", "--pipeline_depth", "2"])
    same, err = state_diff(torch, deep["state"], twin["state"],
                           GEOMETRY["d"])
    restarts = deep["out"]["pipeline_stats"]["restarts"]
    phase("resilience", run="retry_depth2", leaves_bit_equal=same,
          restarts=restarts, launches=launches(deep),
          wall_s=deep["wall_s"])
    check(same, f"resilience depth 2: leaves differ from the twin by {err}")
    check(restarts == 1, f"resilience depth 2: {restarts} restarts")

    n_rec = len(probe.recoveries)
    demote = run("res_demote", base + RES_NAN + [
        "--control_policy", "fixed", "--ladder", RES_LADDER,
        "--control_schedule", "0-=0", "--recover_policy", "demote"])
    d_log = demote["out"]["logdir"]
    rungs = read_metrics(d_log)["control/rung"]
    trail = [int(rungs[s]) for s in sorted(rungs)]
    rec = probe.recoveries[n_rec]
    builds_after = kern.plan_builds() - rec["builds0"]
    holds = [hold_migration(torch, cs, kern, m)
             for m in demote["migrations"]]
    phase("resilience", run="demote", rung_trail=json.dumps(trail),
          end_rung=demote["out"]["control"]["rung"],
          rung_demotions=last_scalar(d_log, "resilience/rung_demotions"),
          plan_builds_in_recovery=rec["builds1"] - rec["builds0"],
          plan_builds_from_recovery_to_end=builds_after,
          migration_k1_max_abs_err=json.dumps([h[0] for h in holds]),
          migration_ms_in_run=json.dumps([round(h[1], 4) for h in holds]),
          launches=launches(demote), wall_s=demote["wall_s"])
    check(trail == [0] * RES_ROLLBACK + [1] * RES_REPLAYED
          and demote["out"]["control"]["rung"] == 1,
          f"resilience demote: rung trail {trail}")
    check(last_scalar(d_log, "resilience/rung_demotions") == 1.0
          and len(holds) == 1, "resilience demote: one demotion")
    check(rec["builds1"] == rec["builds0"] and builds_after == 0,
          f"resilience demote: {builds_after} plans built from the "
          "recovery on")

    skip = run("res_skip", base + RES_NAN + [
        "--recover_policy", "skip_clients"])
    e_log = skip["out"]["logdir"]
    with open(os.path.join(e_log, "comm_ledger.json")) as f:
        led = json.load(f)
    rates = read_metrics(e_log)["fedsim/participation_rate"]
    live = round(sum(rates.values()) * 8)
    blacklisted = last_scalar(e_log, "resilience/blacklisted_clients")
    phase("resilience", run="skip_clients", blacklisted=blacklisted,
          live_client_rounds=led["live_client_rounds"], live_logged=live,
          cum_up_bytes=led["cum_up_bytes"], launches=launches(skip),
          wall_s=skip["wall_s"])
    check(blacklisted >= 1 and last_scalar(
        e_log, "resilience/recoveries") == 1.0,
        f"resilience skip_clients: {blacklisted} blacklisted")
    check(led["live_client_rounds"] == live and led["cum_up_bytes"]
          == live * led["bytes_per_round"]["upload_bytes"],
          f"resilience skip_clients: ledger {led}")

    # (f) preemption: a forced save at round 5, then resumed to round 8;
    # the cv_train process that must exit 75 runs beside (f) and (g)'s
    # in-process runs, whose times no check reads
    ck = os.path.join(work, "res_preempt")
    t_sub = time.perf_counter()
    sub_err = open(ck + "_sub.stderr", "w+")
    sub = subprocess.Popen(
        [sys.executable, "-m", "commefficient_tpu_torch.train.cv_train",
         *MAIN_ARGS, "--chaos", "preempt@0", "--max_rounds", "2",
         "--dataset_dir", dataset_dir, "--logdir", ck + "_sub",
         "--checkpoint_dir", ck + "_sub_ck"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=sub_err)
    flags = base + ["--chaos", f"preempt@{RES_PREEMPT_AT}",
                    "--dataset_dir", dataset_dir, "--checkpoint_dir", ck,
                    "--checkpoint_every", "2", "--max_rounds",
                    str(RES_ROUNDS)]
    gc.collect()
    kern.reset_launch_counts()
    caught = None
    try:
        cv_train.main(flags + ["--logdir", ck + "_a"])
    except SystemExit as e:
        caught = e
    cause = getattr(caught, "__cause__", None)
    second = cv_train.main(flags + ["--resume", "true", "--logdir",
                                    ck + "_b"])
    forms.append(kern.form_counts())
    same, err = state_diff(torch, load_state(os.path.join(
        ck, f"step_{RES_ROUNDS}.pt")), twin["state"], GEOMETRY["d"])
    phase("resilience", run="preempt",
          exit_code=getattr(caught, "code", None),
          saved=getattr(cause, "saved", None),
          shutdown_step=getattr(cause, "step", None),
          resumed_from=second["checkpoint"]["resumed_from"],
          leaves_bit_equal=same)
    check(caught is not None and caught.code == EXIT_PREEMPTED
          and isinstance(cause, PreemptShutdown) and cause.saved
          and cause.step == RES_PREEMPT_AT + 1,
          f"resilience preempt: {caught!r} from {cause!r}")
    check(second["checkpoint"]["resumed_from"] == RES_PREEMPT_AT + 1,
          f"resilience preempt: resumed from {second['checkpoint']}")
    check(same, f"resilience preempt: resumed leaves differ by {err}")

    # (g) C.1: ten rungs prewarmed, a switch to each builds no plan
    gc.collect()
    ten = switch_probe(torch, kern, cv_train, dataset_dir, C1_COLS,
                       [*range(1, 10), 0])
    with sub_err:
        try:
            sub.wait(timeout=600)
        finally:
            sub.kill()  # a no-op once it has exited
        sub_err.seek(0)
        err_text = sub_err.read()
    phase("resilience", run="preempt_subprocess", exit_code=sub.returncode,
          wall_s=round(time.perf_counter() - t_sub, 3))
    check(sub.returncode == EXIT_PREEMPTED,
          f"resilience preempt: cv_train exited {sub.returncode}: "
          f"{err_text[-2000:]}")
    phase("resilience", run="c1_ten_rungs", cols=json.dumps(C1_COLS),
          prewarm_ms=round(ten["prewarm_ms"], 3),
          prewarm_launches=ten["prewarm_launches"],
          plan_builds=ten["plan_builds"],
          switch_ms=json.dumps([round(m, 3) for m in ten["switch_ms"]]),
          launches=json.dumps({k: v for k, v in ten["launches"].items()
                               if v}))
    check(ten["prewarm_launches"] == 0 and ten["plan_builds"] == 0
          and ten["rung"] == 0, f"resilience C.1: {ten}")
    check(ten["launches"]["sketch_rows"] == ten["launches"][
        "estimate_median"] == 2 * 10, f"resilience C.1: {ten['launches']}")
    t_sub = time.perf_counter()
    sub = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--fresh-switch"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    check(sub.returncode == 0, f"resilience fresh switch: exit "
          f"{sub.returncode}: {sub.stderr[-2000:]}")
    fresh = json.loads(sub.stdout.strip().splitlines()[-1])
    first = fresh["switch_ms"][0]
    steady = statistics.median(fresh["switch_ms"][2::2])
    phase("resilience", run="c1_fresh_process",
          switch_ms=json.dumps([round(m, 3) for m in fresh["switch_ms"]]),
          first_ms=round(first, 3), steady_ms=round(steady, 3),
          ratio=round(first / steady, 3), plan_builds=fresh["plan_builds"],
          prewarm_ms=round(fresh["prewarm_ms"], 3),
          subprocess_s=round(time.perf_counter() - t_sub, 3))
    check(fresh["plan_builds"] == 0 and fresh["prewarm_launches"] == 0,
          f"resilience fresh switch: {fresh}")
    check(first <= 2 * steady, f"resilience fresh switch: the first "
          f"switch {first:.3f} ms against {steady:.3f} ms steady")

    snaps = probe.snapshots
    phase("resilience_cost", card=repr(card_line()),
          snapshot_ms_median=round(statistics.median(
              m for m, _ in snaps), 3),
          snapshot_bytes=json.dumps(sorted({b for _, b in snaps})),
          snapshots=len(snaps),
          restore_ms_median=round(statistics.median(probe.restores), 3),
          restores=len(probe.restores),
          recovery_ms=json.dumps([round(m, 3)
                                  for m in probe.recovery_ms()]),
          recovery_ms_median=round(statistics.median(
              probe.recovery_ms()), 3))
    phase("resilience_wall", wall_s=round(time.perf_counter() - t0, 3))
    return add_forms(*forms)


# -- clientstore/: host and mmap client banks, the LRU cache, the streamer --

CS_ROUNDS = 8  # rounds of each clientstore-phase run
CS_CLIENTS = 16
CS_POPULATION = 10_000  # a bank of 262.9 GB: more than the card holds
CS_ARGS = MAIN_ARGS + ["--local_momentum", "0.9", "--telemetry_level", "1",
                       "--device_data", "false"]
CS_BYTES = {"upload_bytes": 10_108_800, "download_bytes": 26_292_520}
CS_LAUNCHES = dict(sketch_rows=2, estimate_median=1, median_rows=2)
CS_SCALARS = ("clientstore/cache_hit_rate", "clientstore/evictions",
              "clientstore/h2d_stage_ms", "clientstore/writeback_ms")
CS_ROW_BYTES = 4 * D_FULL  # one bank row, 26,292,520 B
# C.4's ladders: four num_cols rungs, each visited once a run
C4_COLS = [500_000, 400_000, 300_000, 250_000]
C4_SCHEDULE = "0-0=0,1-1=1,2-2=2,3-3=3,4-=0"
C4_DECODES = {"sharded": SHARDED_FLAGS, "num_blocks_4": ["--num_blocks", "4"]}


class StoreProbe:
    """Inside ``with StoreProbe():`` each session's hosted-store counters
    (``client_store_stats``: the stale cohorts gathered again, the pinned
    bytes) are recorded as the runner closes its store."""

    def __init__(self):
        from commefficient_tpu_torch.parallel import FederatedSession

        self.cls, self.stats = FederatedSession, []

    def __enter__(self):
        self.saved = close = self.cls.close_client_store
        probe = self

        def closing(sess):
            if sess._streamer is not None and not sess._streamer._closed:
                probe.stats.append(dict(sess.client_store_stats))
            return close(sess)

        self.cls.close_client_store = closing
        return self

    def __exit__(self, *exc):
        self.cls.close_client_store = self.saved


def load_blob(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def blob_equal(torch, a, b):
    """(bit-equal, max abs difference) of two checkpoints' FedState leaves
    but the client banks, and of their velocity banks, wherever each
    keeps it (``client_vel`` on the device, ``host_vel`` hosted)."""
    fa, fb = a["fed_state"], b["fed_state"]
    keys = [k for k in fa if k not in ("client_vel", "client_err")]
    same, err = state_diff(torch, {k: fa[k] for k in keys},
                           {k: fb[k] for k in keys}, GEOMETRY["d"])
    va = fa["client_vel"] if fa["client_vel"] is not None else a["host_vel"]
    vb = fb["client_vel"] if fb["client_vel"] is not None else b["host_vel"]
    bank = torch.equal(va, vb)
    return same and bank, max(err, float((va - vb).abs().max()))


def rss_bytes():
    """(resident bytes now, the process's peak resident bytes): VmRSS and
    ``ru_maxrss`` (gVisor's kernel does not report VmHWM)."""
    import resource

    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) * 1024 for line in f
                   if line.startswith("VmRSS:"))
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def c4_probe(torch, kern, cv_train, dataset_dir, flags):
    """C.4 on the card: a full-width main-path session on a ``num_cols``
    ladder of C4_COLS under ``flags`` (the sharded decode, or
    ``--num_blocks 4``), prewarmed by its controller, then C4_SCHEDULE's
    5 rounds (every rung once, 4 switches, each migrating the tables):
    the plan builds from the prewarm's end to the last round's, the
    prewarm's launches, the switches and the rounds' launches."""
    from commefficient_tpu_torch.control import build_controller
    from commefficient_tpu_torch.data import FedSampler
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.utils.config import parse_args

    cfg = parse_args(MAIN_ARGS + flags + [
        "--telemetry_level", "1", "--control_policy", "fixed",
        "--control_schedule", C4_SCHEDULE, "--dataset_dir", dataset_dir,
        "--ladder", "num_cols=" + ",".join(str(c) for c in C4_COLS)])
    train, _, _, params, loss_fn, augment = cv_train.build_model_and_data(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the envelope, the 1-device decode
        sess = FederatedSession(cfg, params, loss_fn)
    ctrl = build_controller(cfg, sess, num_rounds=5)
    kern.reset_launch_counts()
    ctrl.prewarm()
    torch.cuda.synchronize()
    prewarm_launches = sum(kern.launch_counts().values())
    builds = kern.plan_builds()
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size,
                         seed=cfg.seed, augment=augment)
    for s in range(5):
        ids, batch = sampler.sample_round(s)
        sess.train_round(ids, batch, 0.1)
    torch.cuda.synchronize()
    return dict(plan_builds=kern.plan_builds() - builds,
                prewarm_launches=prewarm_launches, switches=ctrl.switches,
                rung=sess.active_rung, launches=kern.launch_counts(),
                forms=kern.form_counts())


def clientstore_phase(torch, kern, cv_train, dataset_dir, work):
    """Host-resident client state (``clientstore/``) on the card: the main
    path with local momentum (CS_ARGS: one [num_clients, D] velocity
    bank) at level 1 for CS_ROUNDS rounds on deterministic cuDNN, on the
    host data path, each run through ``cv_train.main`` with the counters
    set to 0 just before it and read just after:

    (a) at CS_CLIENTS clients, ``device`` (the bank on the card),
    ``host``, ``mmap`` (a named file in the phase's directory) and
    ``host`` with ``--client_store_cache_rows 4``: every FedState leaf,
    the velocity bank and every loss bit-equal to the device run, K1 16,
    K2 8 and K3 16 launches a run, the bytes per round of
    ``sketch_local_momentum``, no bank in the hosted checkpoints' state;
    (b) ``host`` at ``--pipeline_depth 2``, bit-equal, its stale cohorts
    gathered again counted; (c) CS_POPULATION clients: the device bank's
    allocation raises ``torch.OutOfMemoryError``, and ``mmap`` trains
    CS_ROUNDS rounds with finite losses, its file's allocated bytes
    (``st_blocks``, or the free disk's drop where the file system reports
    no holes) at most the rows written plus slack (host RSS, the round ms
    median, the ``clientstore/*`` scalars and the pinned bytes printed);
    (d) a ``host`` run checkpointed at round 4 and resumed to CS_ROUNDS,
    bit-equal to (a), its checkpoint carrying ``host_vel``; (e) the round
    ms of ``device``, ``host`` and ``mmap`` at depths 0 and 2 side by
    side; (f) C.4: under the sharded decode and at ``--num_blocks 4``, a
    4-rung ``num_cols`` ladder prewarmed and every rung visited with no
    plan built after the prewarm. Returns the summed launch forms."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _clientstore_phase(torch, kern, cv_train, dataset_dir, work)
    finally:
        torch.backends.cudnn.deterministic = prev


def _clientstore_phase(torch, kern, cv_train, dataset_dir, work):
    t0 = time.perf_counter()
    forms = []
    probe = StoreProbe()
    base = CS_ARGS + ["--num_clients", str(CS_CLIENTS)]
    runs = {}

    def run(name, args):
        gc.collect()
        t = time.perf_counter()
        n = len(probe.stats)
        with probe:
            r = state_run(torch, kern, cv_train, dataset_dir, work, name,
                          base + args + ["--logdir",
                                         os.path.join(work, name)],
                          rounds=CS_ROUNDS)
        forms.append(r["forms"])
        r["wall_s"] = round(time.perf_counter() - t, 3)
        r["store"] = probe.stats[n] if len(probe.stats) > n else {}
        r["blob"] = load_blob(os.path.join(work, name,
                                           f"step_{CS_ROUNDS}.pt"))
        r["scalars"] = {k: v for k, v in read_metrics(
            r["out"]["logdir"]).items() if k.startswith("clientstore/")}
        r["ms"] = statistics.median(r["round_ms"][1:])
        runs[name] = r
        return r

    def launches_ok(name, ln, rounds=CS_ROUNDS):
        for k, per in CS_LAUNCHES.items():
            check(ln[k] == per * rounds, f"clientstore {name}: {k} "
                  f"launched {ln[k]} times, expected {per * rounds}")
        check(ln["estimate_at"] == ln["estimate_at_range"] == 0,
              f"clientstore {name}: K4 launched: {ln}")

    def hold(name, r, hosted=True):
        same, err = blob_equal(torch, r["blob"], dev["blob"])
        losses = [h["loss"] for h in r["out"]["history"]]
        bpr = r["out"]["bytes_per_round"]
        stats = r["scalars"]
        phase("clientstore", run=name, leaves_bit_equal=same,
              max_abs_err=err, losses_bit_equal=losses == dev_losses,
              launches=json.dumps({k: v for k, v in r["launches"].items()
                                   if v}), data=r["out"]["data_path"],
              round_ms_median=round(r["ms"], 3),
              stage_ms_median=round(statistics.median(stats.get(
                  "clientstore/h2d_stage_ms", {0: 0.0}).values()), 3),
              writeback_ms_median=round(statistics.median(stats.get(
                  "clientstore/writeback_ms", {0: 0.0}).values()), 3),
              hit_rate=json.dumps([round(v, 4) for _, v in sorted(stats.get(
                  "clientstore/cache_hit_rate", {}).items())]),
              store=json.dumps(r["store"]), peak=r["peak"],
              wall_s=r["wall_s"])
        check(same, f"clientstore {name}: the state differs from the "
              f"device bank's by {err}")
        check(losses == dev_losses, f"clientstore {name}: losses differ")
        launches_ok(name, r["launches"])
        check(all(bpr[k] == v for k, v in CS_BYTES.items()),
              f"clientstore {name}: bytes per round {bpr}")
        fs = r["blob"]["fed_state"]
        if hosted:
            check(fs["client_vel"] is None and "host_vel" in r["blob"]
                  and set(stats) == set(CS_SCALARS) and r["store"],
                  f"clientstore {name}: not hosted ({sorted(stats)})")
        else:
            check(fs["client_vel"] is not None and not stats,
                  f"clientstore {name}: the device bank's run hosted")

    # (a) the four stores at CS_CLIENTS clients
    dev = run("cs_device", [])
    dev_losses = [h["loss"] for h in dev["out"]["history"]]
    hold("device", dev, hosted=False)
    hold("host", run("cs_host", ["--client_store", "host"]))
    hold("mmap", run("cs_mmap", [
        "--client_store", "mmap", "--client_store_path",
        os.path.join(work, "cs_bank")]))
    cached = run("cs_cached", ["--client_store", "host",
                               "--client_store_cache_rows", "4"])
    hold("cached", cached)
    check(sum(cached["scalars"]["clientstore/evictions"].values()) > 0,
          "clientstore cached: no eviction")

    # (b) + (e) depth 2 for every store
    deep = run("cs_host_depth2", ["--client_store", "host",
                                  "--pipeline_depth", "2"])
    hold("host_depth2", deep)
    check(deep["store"]["regathers"] > 0, "clientstore depth 2: no cohort "
          "was gathered again (16 clients, 8 a round: they collide)")
    hold("mmap_depth2", run("cs_mmap_depth2", [
        "--client_store", "mmap", "--client_store_path",
        os.path.join(work, "cs_bank2"), "--pipeline_depth", "2"]))
    hold("device_depth2", run("cs_device_depth2", ["--pipeline_depth", "2"]),
         hosted=False)
    phase("clientstore_round_ms", card=repr(card_line()), **{
        name: round(runs[f"cs_{name}"]["ms"], 3) for name in (
            "device", "host", "mmap", "cached", "device_depth2",
            "host_depth2", "mmap_depth2")})

    # (d) checkpointed at round 4, resumed to CS_ROUNDS
    ck = os.path.join(work, "cs_resume")
    half = CS_ROUNDS // 2
    gc.collect()
    kern.reset_launch_counts()
    flags = base + ["--client_store", "host", "--dataset_dir", dataset_dir,
                    "--checkpoint_dir", ck, "--checkpoint_every", str(half)]
    cv_train.main(flags + ["--max_rounds", str(half), "--logdir",
                           ck + "_a"])
    at_half = load_blob(os.path.join(ck, f"step_{half}.pt"))
    second = cv_train.main(flags + ["--max_rounds", str(CS_ROUNDS),
                                    "--resume", "true", "--logdir",
                                    ck + "_b"])
    forms.append(kern.form_counts())
    launches_ok("resume", kern.launch_counts())
    same, err = blob_equal(torch, load_blob(os.path.join(
        ck, f"step_{CS_ROUNDS}.pt")), dev["blob"])
    phase("clientstore", run="resume",
          resumed_from=second["checkpoint"]["resumed_from"],
          carries_host_vel="host_vel" in at_half,
          host_vel_shape=json.dumps(list(at_half["host_vel"].shape)),
          checkpoint_bytes=second["checkpoint"]["bytes"],
          restore_ms=second["checkpoint"]["restore_ms"],
          leaves_bit_equal=same, max_abs_err=err)
    check(second["checkpoint"]["resumed_from"] == half
          and "host_vel" in at_half, "clientstore resume: no hosted resume")
    check(same, f"clientstore resume: differs from the straight run by "
          f"{err}")
    del at_half
    for r in runs.values():
        r.pop("blob", None)

    # (c) a population whose bank the card cannot hold
    import shutil

    oom = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)
    pop = CS_ARGS + ["--num_clients", str(CS_POPULATION), "--dataset_dir",
                     dataset_dir, "--max_rounds", str(CS_ROUNDS)]
    gc.collect()
    caught = None
    try:
        cv_train.main(pop + ["--logdir", os.path.join(work, "cs_oom")])
    except oom as e:
        caught = e
    gc.collect()
    torch.cuda.empty_cache()
    check(caught is not None, "clientstore population: the device bank of "
          f"{CS_POPULATION} clients was allocated")
    bank = os.path.join(work, "cs_population")
    free = shutil.disk_usage(work).free
    kern.reset_launch_counts()
    n = len(probe.stats)
    with probe:
        big = cv_train.main(pop + ["--client_store", "mmap",
                                   "--client_store_path", bank, "--logdir",
                                   os.path.join(work, "cs_pop")])
    forms.append(kern.form_counts())
    launches_ok("population", kern.launch_counts())
    rss, hwm = rss_bytes()
    st = os.stat(bank + ".vel")
    blocks = st.st_blocks * 512
    drop = free - shutil.disk_usage(work).free  # the runner's close synced
    # a file system that reports no holes gives the whole size in
    # st_blocks (gVisor's 9p mounts do); the free space's drop is then
    # what the file took
    allocated, measure = ((blocks, "st_blocks") if blocks < st.st_size
                          else (drop, "free_disk_drop"))
    losses = [h["loss"] for h in big["history"]]
    stats = {k: v for k, v in read_metrics(big["logdir"]).items()
             if k.startswith("clientstore/")}
    limit = CS_ROUNDS * 8 * CS_ROW_BYTES + (64 << 20)
    phase("clientstore", run="population", clients=CS_POPULATION,
          bank_bytes_logical=st.st_size, bank_bytes_allocated=allocated,
          allocated_by=measure, st_blocks_bytes=blocks,
          free_disk_drop=drop, allocated_limit=limit, free_disk_before=free,
          device_oom=repr(str(caught).splitlines()[0][:120]),
          rounds=len(losses), losses=json.dumps(losses),
          round_ms_median=round(statistics.median(
              h["ms"] for h in big["history"][1:]), 3),
          host_rss=rss, host_rss_peak=hwm,
          scalars=json.dumps({k: [round(x, 4) for _, x in sorted(v.items())]
                              for k, v in stats.items()}),
          store=json.dumps(probe.stats[n] if len(probe.stats) > n else {}),
          card=repr(card_line()))
    check(st.st_size == CS_POPULATION * CS_ROW_BYTES,
          f"clientstore population: the bank file is {st.st_size} B")
    check(len(losses) == CS_ROUNDS and all(math.isfinite(x)
                                           for x in losses),
          f"clientstore population: losses {losses}")
    check(allocated <= limit, f"clientstore population: {allocated} B "
          f"allocated for at most {CS_ROUNDS * 8} rows")
    check(set(stats) == set(CS_SCALARS), "clientstore population: scalars")
    os.unlink(bank + ".vel")

    # (f) C.4
    for name, flags in C4_DECODES.items():
        gc.collect()
        r = c4_probe(torch, kern, cv_train, dataset_dir, flags)
        forms.append(r["forms"])
        phase("clientstore", run=f"c4_{name}", plan_builds=r["plan_builds"],
              prewarm_launches=r["prewarm_launches"],
              switches=r["switches"], end_rung=r["rung"],
              launches=json.dumps({k: v for k, v in r["launches"].items()
                                   if v}))
        check(r["plan_builds"] == 0 and r["prewarm_launches"] == 0,
              f"clientstore C.4 {name}: {r['plan_builds']} plans built "
              "after the prewarm")
        check(r["switches"] == 4 and r["rung"] == 0,
              f"clientstore C.4 {name}: {r['switches']} switches")
        check(r["launches"]["estimate_at_range"] > 0,
              f"clientstore C.4 {name}: no range-form launch")
    phase("clientstore_wall", wall_s=round(time.perf_counter() - t0, 3))
    return add_forms(*forms)


AF_ROUNDS = 8  # updates of each asyncfed-phase run
AF_BASE = MAIN_ARGS + ["--telemetry_level", "1", "--device_data", "false"]
AF_ANCHOR = ["--async_buffer", "8", "--async_concurrency", "1",
             "--staleness_exponent", "0"]
AF_OVERLAP = ["--async_buffer", "4", "--async_concurrency", "2",
              "--staleness_exponent", "0.5", "--availability", "poisson",
              "--arrival_rate", "0.9"]
AF_DOUBLE = ["--async_double_buffer", "true"]
# every live slot of cohort 3 corrupted: at seed 42 it launches at update
# 5, after the round-4 snapshot, and is consumed by updates 5-8, so the
# round-8 drain finds the divergence and the replay realizes it clean
AF_NAN = ["--chaos", "nan_client@8:rounds=3-3", "--recover_policy", "retry",
          "--snapshot_every", "4"]
AF_ROLLBACK = 4
AF_CONTROL = ["--async_buffer", "4", "--async_concurrency", "3",
              "--staleness_exponent", "0.5", "--availability", "poisson",
              "--arrival_rate", "0.9", "--control_policy", "staleness_aware",
              "--ladder", "num_cols=" + ",".join(str(c) for c in C4_COLS),
              "--control_hysteresis", "1", "--control_staleness_hi", "0.6",
              "--control_staleness_lo", "0.2"]
AF_LAUNCHES = dict(sketch_rows=2, estimate_median=1, median_rows=2)


class PrewarmProbe:
    """Inside ``with PrewarmProbe(kern):`` each session's
    ``prewarm_rungs`` records ``kern.plan_builds()`` as it returns."""

    def __init__(self, kern):
        from commefficient_tpu_torch.parallel import FederatedSession

        self.cls, self.kern, self.builds = FederatedSession, kern, []

    def __enter__(self):
        self.saved = prewarm = self.cls.prewarm_rungs
        probe = self

        def prewarm_rungs(sess):
            out = prewarm(sess)
            probe.builds.append(probe.kern.plan_builds())
            return out

        self.cls.prewarm_rungs = prewarm_rungs
        return self

    def __exit__(self, *exc):
        self.cls.prewarm_rungs = self.saved


def af_window_cohorts(k, c, rounds=AF_ROUNDS, workers=8, seed=42,
                      rate=0.9):
    """The most cohorts the window holds after an update's launches, by
    ``AsyncSchedule``: the launched cohorts with slots left."""
    from commefficient_tpu_torch.asyncfed import AsyncSchedule

    sch = AsyncSchedule(seed=seed, num_workers=workers, buffer_k=k,
                        concurrency=c, arrival_rate=rate,
                        num_updates=10 * rounds)
    consumed, most = {}, 0
    for u in range(rounds):
        launched = sch.launched_before(u + 1)
        most = max(most, sum(consumed.get(cc, 0) < workers
                             for cc in range(launched)))
        for cc, _s in sch.updates[u].slots:
            consumed[cc] = consumed.get(cc, 0) + 1
    return most, sch


def asyncfed_phase(torch, kern, cv_train, dataset_dir, work):
    """Buffered-asynchronous federation (``asyncfed/``) on the card: the
    main path at level 1 for AF_ROUNDS updates on deterministic cuDNN and
    the host data path, each run through ``cv_train.main`` with the
    counters set to 0 just before it and read just after:

    (a) the anchor (K 8, C 1, exponent 0) against the synchronous run:
    every FedState leaf and every loss bit-equal, K1 16, K2 8 and K3 16 in
    both, the ledger's bytes equal (10,108,800 B up and 26,292,520 B
    down a client a round), ``perf_report.json`` with ``engine: "async"``
    and its block; (b) overlap (K 4, C 2, exponent 0.5, poisson 0.9): 8
    finite updates, ``async/staleness_mean`` and ``async/buffer_fill``
    as ``AsyncSchedule`` scripts them, K1 2, K2 1 and K3 2 an update, and
    under the sharded decode K4's range form once an update and K2 never;
    the window's bytes exact by the schedule; (c) (a) and (b) with
    ``--async_double_buffer`` bit-equal to their twins; (d) (b) with
    every live slot of cohort 3 corrupted under ``--recover_policy retry
    --snapshot_every 4``: one rollback to update 4 and bit-equal to (b),
    K1, K2 and K3 at (b)'s plus the 4 replayed updates'; two resumes
    from (b)'s round-4 checkpoint bit-equal to each other; (e)
    ``staleness_aware`` on a 4-rung ``num_cols`` ladder at C 3: a rung
    switch and a (K, C) retune, no plan built after the prewarm; (f)
    printed: each run's ms an update, the median of updates 1-7 and
    their mean (the last runs to the end of the drain, so the mean is
    what the card took), the prefetch and stall ms, the largest window,
    the peak memory and the snapshot's ms. Returns the summed launch
    forms."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _asyncfed_phase(torch, kern, cv_train, dataset_dir, work)
    finally:
        torch.backends.cudnn.deterministic = prev


def _asyncfed_phase(torch, kern, cv_train, dataset_dir, work):
    import shutil

    t0 = time.perf_counter()
    forms = []
    runs = {}
    W, d = 8, D_FULL
    cohort_bytes = W * 4 * (d + 3)  # rows, loss, aux correct and count

    def run(name, args, rounds=AF_ROUNDS):
        gc.collect()
        t = time.perf_counter()
        r = state_run(torch, kern, cv_train, dataset_dir, work, name,
                      AF_BASE + args + ["--logdir", os.path.join(work, name)],
                      rounds=rounds)
        forms.append(r["forms"])
        r["wall_s"] = round(time.perf_counter() - t, 3)
        r["losses"] = [h["loss"] for h in r["out"]["history"]]
        r["ms"] = statistics.median(r["round_ms"][1:])
        # updates 1-7 from the first's dispatch to the end of the drain:
        # what an update costs the card (the host may dispatch ahead)
        r["mean_ms"] = statistics.mean(r["round_ms"][1:])
        r["stats"] = r["out"]["pipeline_stats"] or {}
        r["metrics"] = read_metrics(r["out"]["logdir"])
        runs[name] = r
        return r

    def launches_ok(name, ln, extra=0, per=AF_LAUNCHES):
        for k, n in per.items():
            want = n * (AF_ROUNDS + extra)
            check(ln[k] == want, f"asyncfed {name}: {k} launched {ln[k]} "
                  f"times, expected {want}")

    def held(name, r, twin):
        same, err = state_diff(torch, r["state"], twin["state"], d)
        check(same, f"asyncfed {name}: the state differs from "
              f"{twin['name']} by {err}")
        check(r["losses"] == twin["losses"],
              f"asyncfed {name}: losses differ from {twin['name']}")
        return same

    def short(r):
        return json.dumps({k: v for k, v in r["launches"].items() if v})

    # (a) the anchor against the synchronous round
    sync = run("af_sync", [])
    sync["name"] = "af_sync"
    anchor = run("af_anchor", AF_ANCHOR)
    files = _run_dir_files(anchor["out"]["logdir"])
    ledgers = {}
    for r in (sync, anchor):
        with open(os.path.join(r["out"]["logdir"], "comm_ledger.json")) as f:
            ledgers[r is anchor] = json.load(f)
    bpr = anchor["out"]["bytes_per_round"]
    phase("asyncfed", run="anchor", leaves_bit_equal=held("anchor", anchor,
                                                          sync),
          losses=json.dumps(anchor["losses"]), launches=short(anchor),
          sync_launches=short(sync), upload_bytes=bpr["upload_bytes"],
          download_bytes=bpr["download_bytes"],
          ledger_bytes=ledgers[True]["cum_bytes"],
          sync_ledger_bytes=ledgers[False]["cum_bytes"],
          engine=files["perf"]["engine"],
          async_block=json.dumps(files["perf"].get("async")),
          stats=json.dumps(anchor["stats"]), wall_s=anchor["wall_s"])
    launches_ok("sync", sync["launches"])
    launches_ok("anchor", anchor["launches"])
    check(all(bpr[k] == v for k, v in CS_BYTES.items())
          and sync["out"]["bytes_per_round"] == bpr,
          f"asyncfed anchor: bytes per round {bpr}")
    for key in ("rounds", "cum_up_bytes", "cum_down_bytes", "cum_bytes"):
        check(ledgers[True][key] == ledgers[False][key],
              f"asyncfed anchor: ledger {key} {ledgers[True][key]} against "
              f"the synchronous {ledgers[False][key]}")
    check(ledgers[True]["cum_up_bytes"] == AF_ROUNDS
          * CS_BYTES["upload_bytes"], "asyncfed anchor: ledger upload bytes")
    check(files["perf"]["engine"] == "async" and files["perf"]["async"]
          == {"buffer": 8, "concurrency": 1, "staleness_exponent": 0.0},
          f"asyncfed anchor: perf report {files['perf'].get('engine')}")
    check(anchor["stats"]["window_bytes_max"] == cohort_bytes,
          f"asyncfed anchor: window {anchor['stats']['window_bytes_max']} B")

    # (b) overlap: the schedule's scalars, the launches, the window
    over = run("af_overlap", AF_OVERLAP + ["--checkpoint_every", "4"])
    over["name"] = "af_overlap"
    most, sch = af_window_cohorts(4, 2)
    m = over["metrics"]
    stale = [m["async/staleness_mean"][u] for u in range(AF_ROUNDS)]
    fill = [m["async/buffer_fill"][u] for u in range(AF_ROUNDS)]
    want_stale = [sum(sch.updates[u].staleness) / 4 for u in range(AF_ROUNDS)]
    want_fill = [float(sch.updates[u].buffer_fill_after)
                 for u in range(AF_ROUNDS)]
    st = over["stats"]
    phase("asyncfed", run="overlap", losses=json.dumps(over["losses"]),
          staleness_mean=json.dumps(stale), buffer_fill=json.dumps(fill),
          cohorts_launched=st["cohorts_launched"], launches=short(over),
          window_bytes_max=st["window_bytes_max"],
          window_cohorts_max=st["window_cohorts_max"],
          window_bytes_expected=most * cohort_bytes, wall_s=over["wall_s"])
    check(len(over["losses"]) == AF_ROUNDS
          and all(math.isfinite(x) for x in over["losses"]),
          f"asyncfed overlap: losses {over['losses']}")
    check(stale == want_stale and fill == want_fill,
          f"asyncfed overlap: staleness {stale} / fill {fill} against the "
          f"schedule's {want_stale} / {want_fill}")
    check(max(stale) > 0, "asyncfed overlap: no stale contribution")
    launches_ok("overlap", over["launches"])
    check(st["window_bytes_max"] == most * cohort_bytes
          and st["window_cohorts_max"] == most,
          f"asyncfed overlap: window {st['window_bytes_max']} B, "
          f"{st['window_cohorts_max']} cohorts; the schedule's {most}")
    sharded = run("af_overlap_sharded", AF_OVERLAP + SHARDED_FLAGS)
    ln = sharded["launches"]
    phase("asyncfed", run="overlap_sharded", launches=short(sharded),
          losses=json.dumps(sharded["losses"]), wall_s=sharded["wall_s"])
    check(ln["estimate_at_range"] == AF_ROUNDS and ln["estimate_median"] == 0
          and ln["sketch_rows"] == 2 * AF_ROUNDS,
          f"asyncfed overlap sharded: launches {ln}")
    check(all(math.isfinite(x) for x in sharded["losses"]),
          "asyncfed overlap sharded: losses not finite")

    # (c) double buffering: bit-equal to the twins
    anchor["name"] = "af_anchor"
    a_db = run("af_anchor_db", AF_ANCHOR + AF_DOUBLE)
    o_db = run("af_overlap_db", AF_OVERLAP + AF_DOUBLE)
    phase("asyncfed", run="double_buffer",
          anchor_bit_equal=held("anchor_db", a_db, anchor),
          overlap_bit_equal=held("overlap_db", o_db, over),
          launches=short(o_db))
    launches_ok("anchor_db", a_db["launches"])
    launches_ok("overlap_db", o_db["launches"])

    # (d) the retry recovery and the resumes
    rec = run("af_retry", AF_OVERLAP + AF_NAN)
    r_log = rec["out"]["logdir"]
    rs = rec["stats"]
    phase("asyncfed", run="retry", leaves_bit_equal=held("retry", rec, over),
          recoveries=last_scalar(r_log, "resilience/recoveries"),
          rollback_round=last_scalar(r_log, "resilience/rollback_round"),
          restarts=rs["restarts"], launches=short(rec),
          snapshot_ms=rs["snapshot_ms"], snapshot_bytes=rs["snapshot_bytes"],
          wall_s=rec["wall_s"])
    check(last_scalar(r_log, "resilience/recoveries") == 1.0
          and last_scalar(r_log, "resilience/rollback_round") == AF_ROLLBACK
          and rs["restarts"] == 1, "asyncfed retry: recoveries/rollback")
    launches_ok("retry", rec["launches"], extra=AF_ROUNDS - AF_ROLLBACK)
    resumed = []
    for tag in ("a", "b"):
        ck = os.path.join(work, f"af_resume_{tag}")
        src = os.path.join(work, "af_overlap")
        os.makedirs(os.path.join(ck, "manifests"))
        shutil.copy(os.path.join(src, "step_4.pt"), ck)
        shutil.copy(os.path.join(src, "manifests", "4.json"),
                    os.path.join(ck, "manifests"))
        gc.collect()
        kern.reset_launch_counts()
        out = cv_train.main(AF_BASE + AF_OVERLAP + [
            "--dataset_dir", dataset_dir, "--checkpoint_dir", ck,
            "--resume", "true", "--max_rounds", str(AF_ROUNDS), "--logdir",
            ck + "_log"])
        forms.append(kern.form_counts())
        resumed.append((out, load_state(os.path.join(
            ck, f"step_{AF_ROUNDS}.pt"))))
    same, err = state_diff(torch, resumed[0][1], resumed[1][1], d)
    la = [h["loss"] for h in resumed[0][0]["history"]]
    lb = [h["loss"] for h in resumed[1][0]["history"]]
    to_straight, err_straight = state_diff(torch, resumed[0][1],
                                           over["state"], d)
    phase("asyncfed", run="resume", resumed_from=json.dumps(
        [o["checkpoint"]["resumed_from"] for o, _ in resumed]),
          bit_equal=same and la == lb, max_abs_err=err,
          bit_equal_to_straight=to_straight,
          max_abs_err_to_straight=err_straight)
    check(all(o["checkpoint"]["resumed_from"] == 4 for o, _ in resumed),
          "asyncfed resume: not resumed from round 4")
    check(same and la == lb, f"asyncfed resume: two resumed runs differ by "
          f"{err}")

    # (e) staleness_aware: a switch and a retune, no plan built
    with PrewarmProbe(kern) as pw:
        ctl = run("af_control", AF_CONTROL)
    cm = ctl["metrics"]
    builds = kern.plan_builds() - pw.builds[-1]
    rungs = [cm["control/rung"][u] for u in range(AF_ROUNDS)]
    ks = [cm["control/async_k"][u] for u in range(AF_ROUNDS)]
    cs_ = [cm["control/async_c"][u] for u in range(AF_ROUNDS)]
    cst = ctl["stats"]
    phase("asyncfed", run="control", rungs=json.dumps(rungs),
          async_k=json.dumps(ks), async_c=json.dumps(cs_),
          switches=ctl["out"]["control"]["switches"],
          retunes=cm["control/retunes"][AF_ROUNDS - 1],
          retunes_applied=cst["retunes_applied"],
          plan_builds_after_prewarm=builds, launches=short(ctl),
          losses=json.dumps(ctl["losses"]), wall_s=ctl["wall_s"])
    check(ctl["out"]["control"]["switches"] >= 1
          and cm["control/retunes"][AF_ROUNDS - 1] >= 1
          and cst["retunes_applied"] >= 1,
          f"asyncfed control: rungs {rungs}, K {ks}, C {cs_}")
    check(builds == 0, f"asyncfed control: {builds} plans built after the "
          "prewarm")
    check(all(math.isfinite(x) for x in ctl["losses"]),
          "asyncfed control: losses not finite")

    # (f) timing, printed
    timed = ("af_sync", "af_anchor", "af_anchor_db", "af_overlap",
             "af_overlap_db", "af_overlap_sharded", "af_control")
    phase("asyncfed_timing", card=repr(card_line()),
          update_ms_median=json.dumps({
              name[3:]: round(runs[name]["ms"], 3) for name in timed}),
          update_ms_mean=json.dumps({
              name[3:]: round(runs[name]["mean_ms"], 3) for name in timed}),
          prefetch_host_ms=json.dumps({
              name[3:]: round(runs[name]["stats"]["prefetch_host_ms"], 3)
              for name in ("af_anchor", "af_overlap")}),
          host_stall_ms=json.dumps({
              name[3:]: round(runs[name]["stats"]["host_stall_ms"], 3)
              for name in ("af_anchor", "af_overlap")}),
          window_bytes_max=json.dumps({
              name[3:]: runs[name]["stats"]["window_bytes_max"]
              for name in ("af_anchor", "af_overlap", "af_control")}),
          peak=json.dumps({name[3:]: runs[name]["peak"] for name in (
              "af_sync", "af_anchor", "af_overlap", "af_control")}),
          snapshot_ms=rs["snapshot_ms"], snapshot_bytes=rs["snapshot_bytes"])
    phase("asyncfed_wall", wall_s=round(time.perf_counter() - t0, 3))
    return add_forms(*forms)



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from commefficient_tpu_torch import resolve_device
    from commefficient_tpu_torch.ops import countsketch as cs
    from commefficient_tpu_torch.ops.cuda import build, index_math
    from commefficient_tpu_torch.ops.cuda import countsketch as kern
    from commefficient_tpu_torch.train import cv_train

    dev = resolve_device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    build.load_library()  # one nvcc a source, all started together
    phase("environment", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, gpu=repr(torch.cuda.get_device_name(0)),
          build_s=round(time.perf_counter() - t0, 3),
          nvcc_s=json.dumps(build.build_seconds),
          library=build.library_path().name)
    report = build.ptxas_report(build.library_path().with_suffix(".log"))
    phase("ptxas", kernels=json.dumps({
        name: f"{v['registers']} regs, {v['smem_static_bytes']} B smem, "
              f"{v['spill_stores_bytes']}/{v['spill_loads_bytes']} B spills"
        for name, v in report.items()}))

    entries = kernels_phase(torch, cs, kern, build, index_math, dev)
    entries["cs_estimate_at"] = k4_phase(torch, cs, kern, dev)
    agreement_phase(torch, dev)
    sharded_agreement_phase(torch, dev)
    replay_phase(torch, cs, dev)
    # a path with no CIFAR-10 pickles: the synthetic stand-in
    dataset_dir = os.path.join(ROOT, "build", "no_dataset")
    dense, dense_bytes = main_path_phase(kern, cv_train, dataset_dir)
    sharded = sharded_main_path_phase(kern, cv_train, dataset_dir,
                                      dense_bytes)
    uncompressed_phase(kern, cv_train, dataset_dir)
    paths = {"dense": dense, "sharded": sharded}
    from commefficient_tpu_torch.train.agreement_probe import MODES

    for name, lr in W8_LRS.items():
        agreement_phase(torch, dev, name=f"agreement_{name}", lr=lr,
                        deterministic=True, **MODES[name])
    for name, (flags, up, down) in MODE_PATHS.items():
        paths[name] = mode_path_phase(kern, cv_train, dataset_dir, name,
                                      flags, up, down)
    paths["sketch_local_momentum"] = sketch_local_momentum_phase(
        kern, cv_train, dataset_dir, dense_bytes)
    fused_timing_phase(cv_train, dataset_dir)

    # the GPT-2 workload and the bf16 forms
    from commefficient_tpu_torch.train import gpt2_train
    from commefficient_tpu_torch.train.agreement_probe import (
        gpt2_tiny_session,
    )

    by_geometry = bf16_kernels_phase(torch, cs, kern, dev)
    paths["gpt2"] = gpt2_path_phase(
        kern, gpt2_train, dataset_dir, "gpt2_main_path", [], MAIN_ROUNDS,
        GPT2_BYTES, {"sketch_rows": {"f32": 2 * MAIN_ROUNDS},
                     "estimate_median": {"f32": MAIN_ROUNDS}})
    paths["gpt2_bf16_tables"] = gpt2_path_phase(
        kern, gpt2_train, dataset_dir, "gpt2_bf16_tables",
        ["--sketch_table_dtype", "bfloat16", "--sketch_dtype", "bfloat16"],
        BF16_ROUNDS, {**GPT2_BYTES, "upload_bytes": 50_006_880},
        {"sketch_rows": {"bf16_operand_bf16_table": BF16_ROUNDS,
                         "bf16_operand": BF16_ROUNDS},
         "estimate_median": {"f32_table_bf16_operand": BF16_ROUNDS}})
    paths["sharded_bf16_tables"] = sharded_bf16_phase(kern, cv_train,
                                                      dataset_dir)
    agreement_phase(torch, dev, name="agreement_gpt2", deterministic=True,
                    session=gpt2_tiny_session, **AGREEMENT_GPT2)

    # the fused backward, fedsim, DP, checkpoint/resume
    import tempfile

    entries["cs_sketch_segment"] = segment_phase(torch, cs, kern, dev)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        paths["fused_bwd"] = fused_bwd_phase(torch, kern, cv_train,
                                             dataset_dir, work)
        paths["gpt2_fused_bwd"] = gpt2_fused_bwd_phase(torch, kern,
                                                       gpt2_train,
                                                       dataset_dir)
        paths["fedsim"] = fedsim_phase(torch, kern, cv_train, dataset_dir,
                                       dev)
        dp_phase(torch, cv_train, dataset_dir)
        paths["resume"] = resume_phase(torch, kern, cv_train, dataset_dir,
                                       work)
        # the other datasets, FixupResNet-50, the device-resident data
        paths["device_data"] = device_data_phase(torch, kern, cv_train,
                                                 dataset_dir, work)
        # the host round pipeline: native assembly, prefetch, staging
        native_phase()
        paths["host_pipeline"] = host_pipeline_phase(
            torch, kern, cv_train, dataset_dir, work)
        # the decode options, sparse aggregation, overlap and FSDP
        t_new = time.perf_counter()
        with CachedCifar(cv_train):
            paths.update(decode_options_phase(torch, cs, kern, cv_train,
                                              dataset_dir, work, dev))
            agg_runs, agg_forms = sparse_aggregate_phase(
                torch, kern, cv_train, dataset_dir, work)
            paths.update(agg_forms)
            paths["overlap"] = overlap_phase(torch, kern, cv_train,
                                             dataset_dir, work)
            paths.update(fsdp_phase(torch, kern, cv_train, dataset_dir,
                                    work, agg_runs))
            del agg_runs
        phase("decode_options_to_fsdp", wall_s=round(
            time.perf_counter() - t_new, 3))
    rrc_phase(torch, dev)
    femnist_phase(kern, cv_train, dataset_dir)
    imagenet_fedavg_phase(torch, cv_train, dataset_dir)
    baseline5_host_phase(torch, cv_train, dataset_dir)
    paths["imagenet_fixup_sketch"] = imagenet_sketch_phase(
        torch, kern, cv_train, dataset_dir)
    paths["cifar100"] = cifar100_phase(kern, cv_train, dataset_dir)
    for name, geos in f50_kernels_phase(torch, cs, kern, dev).items():
        by_geometry.setdefault(name, {}).update(geos)
    batched_clients_phase(torch, cv_train, gpt2_train, dataset_dir)
    # the round telemetry: diag/*, the ledger, the flight recorder
    t_tel = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        with CachedCifar(cv_train):
            paths["telemetry"] = telemetry_phase(
                torch, cs, kern, cv_train, gpt2_train, dataset_dir, work, dev)
    phase("telemetry_wall", wall_s=round(time.perf_counter() - t_tel, 3))
    # the host spans, the critical path, the reports, the profiler window
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        with CachedCifar(cv_train):
            paths["spans"] = spans_phase(torch, kern, cv_train, gpt2_train,
                                         dataset_dir, work)
    # the control plane: ladder, policies, switches, budget, resume
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        with CachedCifar(cv_train):
            paths["control"] = control_phase(torch, cs, kern, cv_train,
                                             dataset_dir, work)
    # self-healing: rollback and recovery, the policies, preemption, C.1
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        with CachedCifar(cv_train):
            paths["resilience"] = resilience_phase(torch, cs, kern, cv_train,
                                                   dataset_dir, work)
    # host-resident client state: the stores, the cache, the streamer, C.4
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        with CachedCifar(cv_train):
            paths["clientstore"] = clientstore_phase(torch, kern, cv_train,
                                                     dataset_dir, work)
    # buffered-asynchronous federation: anchor, overlap, double buffering,
    # recovery, resume, staleness_aware
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        with CachedCifar(cv_train):
            paths["asyncfed"] = asyncfed_phase(torch, kern, cv_train,
                                               dataset_dir, work)

    for name, geos in by_geometry.items():
        if name in entries:  # an f32 kernel's GPT-2 numbers
            entries[name]["geometries"] = dict(
                entries[name].get("geometries", {}), **geos)
            continue
        main = geos[FORM_MAIN_GEOMETRY[name]]
        entries[name] = dict(
            replaces=entries[name.split("[")[0]]["replaces"],
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            main_geometry=FORM_MAIN_GEOMETRY[name], geometries=geos)

    def count(forms, name):
        return sum(forms[w].get(f, 0) for w, f in FORMS[name])

    kernels = [dict(name=name, route="cuda", source=e.pop("source", SOURCE),
                    launches=sum(count(p, name) for p in paths.values()),
                    launches_by_path={path: count(p, name)
                                      for path, p in paths.items()},
                    **e)
               for name, e in entries.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(fresh_switch_main() if sys.argv[1:] == ["--fresh-switch"]
             else main())

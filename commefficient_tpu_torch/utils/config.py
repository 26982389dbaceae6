"""Typed configuration — the port's own copy of the reference's ``Config``.

Every field of the reference's ``Config`` (``commefficient_tpu/utils/
config.py``) is here, with its name, type, default and CLI flag, so a
reference command line parses unchanged. A knob the port does not run yet
is REFUSED at construction, unless at its default, with a ``ValueError``
naming the blocker and the ROADMAP item that lifts it (``_UNPORTED``) —
nothing runs quietly with a setting ignored. ``perf_audit`` and
``run_report`` (on by default, as in the reference) write
``perf_report.json`` and ``run_report.json`` at ``telemetry_level >= 1``;
``profile_rounds`` ("A-B") traces those rounds with ``torch.profiler``.
The control plane's flags (``control_policy`` none|fixed|budget_pacing|
ef_feedback, ``ladder``, ``budget_mb``, ``control_schedule``,
``control_ef_up``, ``control_ef_down``, ``control_fidelity_max``,
``control_hysteresis``, and the ``staleness_aware`` policy's
``control_staleness_*`` / ``control_fill_*``) are checked as the reference
checks them (``_validate_control``; ``control_enabled`` gates the build).
The buffered-asynchronous engine's flags (``async_buffer``,
``async_concurrency``, ``staleness_exponent``, ``async_double_buffer``)
are checked as the reference checks them (``_validate_asyncfed``;
``asyncfed_enabled`` gates asyncfed/). The self-healing
flags (``recover_policy`` none|retry|demote|skip_clients,
``snapshot_every``, ``max_recoveries``, ``preempt_signals``) are checked
as the reference checks them (``_validate_resilience``;
``recovery_enabled`` gates the build). So are the client-state placement
flags (``client_store`` device|host|mmap, ``client_store_cache_rows``,
``client_store_path`` and the reference's deprecated alias
``offload_client_state``, which warns and becomes ``client_store='host'``;
``_validate_client_store``; ``client_state_hosted`` gates clientstore/).

Two fields are the port's own: ``device`` (``cuda`` by default, ``cpu`` for
the plain PyTorch path the tests run) and ``max_rounds`` (stop after that
many rounds and evaluate — the quick end-to-end check ``chip_smoke.py``
makes at full model width).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

# the reference's six modes, all ported (the compress/ registry)
MODES = ("uncompressed", "sketch", "true_topk", "local_topk", "fedavg",
         "powersgd")
ERROR_TYPES = ("none", "local", "virtual")
CLIENT_STORES = ("device", "host", "mmap")
# mirrors the fedsim/ availability registry (fedsim.available_models);
# pinned equal by tests/test_torch_fedsim.py
AVAILABILITY_MODELS = ("always", "bernoulli", "cohort", "poisson", "sine")
# mirrors the resilience/ policy registry (available_recover_policies);
# pinned equal by tests/test_torch_resilience.py
RECOVER_POLICIES = ("none", "retry", "demote", "skip_clients")

# field -> ROADMAP item that ports it; any value but the default is refused
_UNPORTED = {
    "model_axis": "tensor parallelism (ROADMAP A17)",
    "seq_axis": "sequence parallelism (ROADMAP A17)",
    "num_hosts": "multihost/ (ROADMAP A11)",
    "distributed": "multihost/ (ROADMAP A11)",
    "distributed_connect_retries": "multihost/ (ROADMAP A11)",
    "max_retraces": "the round's CUDA-graph capture (ROADMAP A11, "
                    "scan_engine): the port compiles no round, so nothing "
                    "retraces",
    "scan_rounds": "the scan round engine (ROADMAP A11)",
}
# cv_train's models (``resnet50`` is the reference's alias of
# ``fixup_resnet50``) and gpt2_train's
CV_MODELS = ("resnet9", "fixup_resnet50", "resnet50")
MODELS = CV_MODELS + ("gpt2", "gpt2_tiny")
CV_DATASETS = ("cifar10", "cifar100", "femnist", "imagenet")
# the datasets each model trains on
MODEL_DATASETS = {**{m: CV_DATASETS for m in CV_MODELS},
                  "gpt2": ("personachat",), "gpt2_tiny": ("personachat",)}


@dataclass(frozen=True)
class Config:
    """All knobs of a federated run. Field names follow the reference."""

    # --- compression / mode ---
    mode: str = "uncompressed"
    k: int = 50_000  # sparsity of the extracted update (sketch mode)
    topk_method: str = "exact"
    num_rows: int = 5  # sketch rows r
    num_cols: int = 500_000  # sketch columns c (requested)
    num_blocks: int = 1
    do_topk_down: bool = False  # top-k compress the downlink too

    # --- powersgd (compress/powersgd.py; PowerSGD, arXiv:1905.13727) ---
    # rank r of the warm-started power iteration on the [n, m]
    # matricization of the flat update; the downlink is r*(n+m) floats
    powersgd_rank: int = 4
    # carry Q across rounds in FedState.comp (the paper's warm start);
    # False draws a fresh Gaussian Q from (seed, step) every round
    powersgd_warm_start: bool = True

    # --- momentum / error feedback ---
    virtual_momentum: float = 0.0  # server-side momentum factor rho
    local_momentum: float = 0.0  # per-client momentum factor
    error_type: str = "none"
    error_decay: float = 1.0
    # None = AUTO (False for sketch: FetchSGD Alg 1 does not mask sketched
    # momentum)
    momentum_dampening: Optional[bool] = None
    # momentum_dampening=True with mode=sketch re-sketches noisy momentum
    # estimates every round; the reference gates it as divergent at paper
    # scale and keeps it for parity experiments behind this opt-in
    allow_unstable_sketch_dampening: bool = False

    # --- federation shape ---
    num_clients: int = 16
    num_workers: int = 8
    num_devices: int = 1
    local_batch_size: int = 8
    iid: bool = True

    # --- fedavg ---
    num_local_iters: int = 1
    # None: local SGD steps run at the round's server lr, so the applied
    # delta is the averaged local weight delta (true FedAvg)
    local_lr: Optional[float] = None

    # --- optimization ---
    lr_scale: float = 0.4
    pivot_epoch: int = 5
    num_epochs: int = 24
    max_grad_norm: Optional[float] = None
    weight_decay: float = 5e-4

    # --- model / dataset ---
    model: str = "resnet9"
    dataset_name: str = "cifar10"
    dataset_dir: str = "./data"
    synthetic_variant: str = "flat"

    # --- GPT-2 workload (gpt2_train) ---
    model_checkpoint: str = "gpt2"  # a directory holding pytorch_model.bin
    num_candidates: int = 2
    max_history: int = 2
    lm_coef: float = 1.0
    mc_coef: float = 1.0
    max_seq_len: int = 256
    # mixed: bf16 model compute over f32 params; bfloat16: also the params
    # cast at the loss boundary (GPT-2's embeddings, residual stream and
    # tied head run bf16); float32: f32 throughout
    compute_dtype: str = "mixed"
    # one flattened-batch gradient per device in place of the per-client
    # loop: the same math when nothing per-client is configured (the
    # round's gate, parallel/round.py ``fused_clients``)
    fuse_clients: bool = False
    # where the [num_clients, D] client banks live: "device" (FedState
    # tensors), "host" (a numpy bank in host RAM) or "mmap" (a
    # memory-mapped file): the hosted stores stream each cohort's rows
    # through clientstore/ (client_state_hosted)
    client_store: str = "device"
    # rows of the hosted stores' LRU cache of device rows (0: no cache)
    client_store_cache_rows: int = 0
    # the mmap store's file ("" = a temporary file unlinked at the end);
    # a named path is reopened with its rows
    client_store_path: str = ""
    # the reference's deprecated alias of client_store="host" (warns)
    offload_client_state: bool = False

    # --- CountSketch ---
    # the sketch's OPERAND type: bfloat16 rounds each signed value to bf16
    # before the f32 accumulation, and each table entry to bf16 before the
    # estimate (the reference's einsum operand dtype)
    sketch_dtype: str = "float32"
    # the tables' STORAGE type: bfloat16 stores the [r, c] tables (the
    # upload, the server's momentum and error) in bf16, while every sum
    # and the server algebra stay f32
    sketch_table_dtype: str = "float32"
    sketch_band: int = 16
    sketch_m: Optional[int] = None
    hash_family: str = "fmix32"
    # "einsum" and "pallas" select ONE realization in the port: the CUDA
    # kernels (ops/cuda/) on a CUDA tensor, their plain PyTorch versions on
    # a CPU tensor. Both names stay accepted so reference command lines run
    # unchanged; the reference pins its two backends equal to fp32 rounding
    # (tests/test_countsketch_pallas.py), so nothing is lost by merging them.
    sketch_backend: str = "einsum"
    sketch_decode: str = "auto"

    # the sketch-fused backward: on the fused flattened-batch path of mode
    # sketch, the gradient is produced as a table by per-leaf taps, and the
    # flat [D] gradient never exists (parallel/round.py
    # make_sketch_grad_one)
    sketch_fused_bwd: bool = False

    # --- worker-side DP: after the clip, each client's gradient gets
    # N(0, (dp_noise_multiplier * max_grad_norm)^2) per coordinate ---
    dp_noise_multiplier: float = 0.0

    # --- fedsim (fedsim/): who participates in a round ---
    # always | bernoulli | sine | cohort | poisson; masked clients
    # transmit nothing and the server renormalizes by the live count
    availability: str = "always"
    # drop probability (bernoulli), peak drop probability (sine), outage
    # probability a cohort (cohort), decline probability (poisson); [0, 1)
    dropout_prob: float = 0.0
    availability_period: int = 64  # sine period, rounds
    num_cohorts: int = 4  # cohort model: slot i belongs to cohort i % n
    arrival_rate: float = 1.0  # poisson model's arrival rate
    # chaos plan "kind@value[:rounds=A-B],..." (fedsim/faults.py): kinds
    # dropout, straggler, nan_client
    chaos: str = ""

    # --- checkpoint/resume (utils/checkpoint.py) ---
    checkpoint_dir: str = ""
    checkpoint_every: int = 0  # rounds between checkpoints; 0 = off
    resume: bool = False

    # --- the other datasets (data/emnist.py, data/imagenet.py) ---
    # the synthetic FEMNIST stand-in's label-noise fraction (real LEAF data
    # is never perturbed); 0 reproduces the noise-free stand-in
    label_noise: float = 0.06
    # None: derived from dataset_name (resolved_num_classes)
    num_classes: Optional[int] = None
    # keep the training set on the device when it fits device_data_max_mb
    # (MB of 1e6 bytes): a round then ships [W, B] sample indices and the
    # augment plan, and the gather and augment run on the device
    # (FederatedSession.maybe_attach_data)
    device_data: bool = True
    device_data_max_mb: int = 512

    # --- the pipelined round engine (pipeline/) ---
    # rounds realized ahead on a worker thread, their arrays copied to the
    # device early; 0 = the synchronous loop (the sampler still prefetches)
    pipeline_depth: int = 0

    # --- the worker group's collectives (parallel/, ops/collectives) ---
    # shard params and dense server state [padded_dim / W] over the group
    # (parallel/fsdp.py): uncompressed, true_topk, sketch; threshold top-k
    fsdp: bool = False
    # how the round sums over the group: auto (sparse only for local_topk
    # with the threshold top-k on more than one device), dense (one
    # all_reduce), sparse ((idx, val) pair exchange; true_topk shards its
    # server state, sketch's error feedback rides the pair gather)
    aggregate: str = "auto"
    # none | layerwise: the fused backward's per-leaf-group table sums,
    # started as the backward finishes each group, and the segmented pair
    # gathers
    overlap_collectives: str = "none"

    # --- telemetry (telemetry/, utils/logging.py, utils/profiling.py) ---
    # 0 off; 1 the diag/* norms and sentinel, comm/* bytes, the flight
    # recorder; 2 + compressor fidelity (telemetry/__init__.py)
    telemetry_level: int = 0
    # drained rounds the flight recorder keeps for its dump
    flight_window: int = 16
    tensorboard: bool = False  # TensorBoard beside metrics.jsonl
    logdir: str = "runs"  # the run dirs' parent (utils/logging.make_logdir)
    # a torch.profiler trace of a few steady-state rounds (StepProfiler)
    profile_dir: str = ""
    # level >= 1: measure the first dispatched round into perf_report.json
    # (telemetry/round_audit.py), and write run_report.json at close
    # (telemetry/trace.py)
    perf_audit: bool = True
    run_report: bool = True
    # "A-B": trace rounds A..B (inclusive, clamped past the warm-up) with
    # torch.profiler into profile_dir or <run dir>/profile_rounds
    profile_rounds: str = ""

    # --- the control plane (control/): a compression ladder and the
    # policy that walks it ---
    # none | fixed (control_schedule) | budget_pacing (spend budget_mb
    # evenly over the remaining rounds) | ef_feedback (the EF residual's
    # slope and the level-2 fidelity, with hysteresis) | staleness_aware
    # (asyncfed only: async/staleness_mean walks the ladder, and the
    # buffer backlog retunes the engine's (K, C))
    control_policy: str = "none"
    # ";"-separated "field=v1,v2,..." (control/ladder.py): k, num_cols,
    # powersgd_rank, one value per rung, most expensive first
    ladder: str = ""
    # a hard cap on the ledger's cumulative bytes, in MB of 1e6 B (0: none)
    budget_mb: float = 0.0
    # fixed: "A-B=rung" round ranges, e.g. "0-99=2,100-=0"
    control_schedule: str = ""
    # ef_feedback: slope > control_ef_up climbs one rung toward more bytes,
    # slope < control_ef_down steps one rung cheaper; a level-2
    # *_rel_err above control_fidelity_max (> 0) climbs too
    control_ef_up: float = 0.15
    control_ef_down: float = 0.0
    control_fidelity_max: float = 0.0
    # rounds between two ef_feedback switches (staleness_aware: between
    # two switches, and between two (K, C) retunes)
    control_hysteresis: int = 8
    # staleness_aware: async/staleness_mean above hi steps one rung
    # cheaper, below lo climbs one; the backlog buffer_fill / K above
    # fill_hi grows K, and at or below fill_lo (with stale cohorts) K
    # shrinks
    control_staleness_hi: float = 2.0
    control_staleness_lo: float = 0.5
    control_fill_hi: float = 1.0
    control_fill_lo: float = 0.25

    # --- buffered-asynchronous federation (asyncfed/) ---
    # K > 0: a server update fires once K client contributions have
    # arrived (FedBuff); 0 = synchronous rounds
    async_buffer: int = 0
    # cohorts in flight at once
    async_concurrency: int = 1
    # alpha of the staleness discount (1 + s)^-alpha
    staleness_exponent: float = 0.0
    # fence an update's apply only after the next update's launches
    async_double_buffer: bool = False

    # --- self-healing (resilience/) ---
    # what a caught DivergenceError does: none (the run dies) | retry
    # (roll back to the last snapshot and replay; the nan_client injection
    # is transient, so the healed run is the unbroken one) | demote (also
    # floor the control/ ladder one rung cheaper) | skip_clients (also
    # mask the suspect clients out of every later round). Needs
    # --telemetry_level >= 1, whose drains detect the divergence
    recover_policy: str = "none"
    # rounds between two drain-certified state snapshots (host memory)
    snapshot_every: int = 16
    # recoveries a run may take before the DivergenceError is re-raised
    max_recoveries: int = 2
    # SIGTERM/SIGINT request a preemption-safe shutdown (drain, force-save,
    # exit 75) at the next round boundary; chaos "preempt@R" is its twin
    preempt_signals: bool = False

    # --- refused until their ROADMAP item lands (see _UNPORTED) ---
    model_axis: int = 1
    seq_axis: int = 1
    num_hosts: int = 1
    distributed: bool = False
    distributed_connect_retries: int = 3
    max_retraces: Optional[int] = None
    scan_rounds: int = 0

    seed: int = 42

    # --- the port's own ---
    device: str = "cuda"  # "cuda" | "cpu"; cuda raises when absent
    max_rounds: int = 0  # > 0: stop after this many rounds, then evaluate

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.error_type not in ERROR_TYPES:
            raise ValueError(
                f"error_type must be one of {ERROR_TYPES}, got "
                f"{self.error_type!r}"
            )
        self._validate_pipeline()
        self._validate_asyncfed()
        for name, blocker in _UNPORTED.items():
            default = Config.__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} is not ported yet: "
                    f"{blocker}; leave it at {default!r}"
                )
        self._validate_control()
        self._validate_resilience()
        from commefficient_tpu_torch.telemetry import TELEMETRY_LEVELS

        if self.telemetry_level not in TELEMETRY_LEVELS:
            raise ValueError(
                f"telemetry_level must be 0 (off), 1 (health) or 2 "
                f"(+fidelity), got {self.telemetry_level!r}")
        if self.profile_rounds:
            from commefficient_tpu_torch.telemetry.trace import (
                parse_profile_rounds,
            )

            parse_profile_rounds(self.profile_rounds)  # names a bad spec
        if self.flight_window < 1:
            raise ValueError(
                f"flight_window must be >= 1, got {self.flight_window}")
        if self.num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got "
                             f"{self.num_devices}")
        if self.topk_method not in ("exact", "threshold", "approx"):
            raise ValueError(
                "topk_method must be exact|threshold|approx, got "
                f"{self.topk_method!r}"
            )
        if self.sketch_decode not in ("auto", "dense", "sharded"):
            raise ValueError(
                "sketch_decode must be auto|dense|sharded, got "
                f"{self.sketch_decode!r}"
            )
        if self.sketch_decode == "sharded":
            if self.mode != "sketch":
                raise ValueError(
                    "sketch_decode='sharded' is the sketch server-decode "
                    f"strategy; mode={self.mode!r} has no sketch decode. "
                    "Leave sketch_decode='auto' (a no-op for other modes)."
                )
            if self.topk_method != "threshold":
                raise ValueError(
                    "sketch_decode='sharded' extracts the global top-<=k "
                    "with the sharded threshold selection (scalar-only "
                    "collectives); set topk_method='threshold', or leave "
                    "sketch_decode='auto' to keep "
                    f"topk_method={self.topk_method!r} on the dense decode"
                )
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got "
                             f"{self.num_blocks}")
        self._validate_client_store()
        self._validate_aggregate()
        self._validate_overlap_collectives()
        for name in ("sketch_dtype", "sketch_table_dtype"):
            v = getattr(self, name)
            if v not in ("float32", "bfloat16"):
                raise ValueError(f"{name} must be float32|bfloat16, got {v!r}")
        if self.hash_family not in ("fmix32", "poly4"):
            raise ValueError(
                f"hash_family must be fmix32|poly4, got {self.hash_family!r}"
            )
        if self.sketch_backend not in ("einsum", "pallas"):
            raise ValueError(
                "sketch_backend must be einsum|pallas, got "
                f"{self.sketch_backend!r}"
            )
        if self.compute_dtype not in ("mixed", "float32", "bfloat16"):
            raise ValueError(
                "compute_dtype must be mixed|float32|bfloat16, got "
                f"{self.compute_dtype!r}"
            )
        if self.mode == "powersgd":
            if self.powersgd_rank < 1:
                raise ValueError(
                    f"powersgd_rank must be >= 1, got {self.powersgd_rank}")
            if self.do_topk_down:
                raise ValueError(
                    "do_topk_down with mode='powersgd' is contradictory: "
                    "the downlink is already the factored rank-r pair "
                    "(r*(n+m) floats); top-k'ing the reconstructed delta "
                    "would only un-compress it. Drop one of the two flags.")
            if self.momentum_dampening is True:
                raise ValueError(
                    "momentum_dampening is undefined for mode='powersgd': "
                    "dampening zeroes momentum at EXTRACTED COORDINATES, "
                    "and a rank-r subspace update has no coordinate "
                    "selection to mask. Use momentum_dampening=None/False.")
        if self.num_local_iters < 1:
            raise ValueError(
                f"num_local_iters must be >= 1, got {self.num_local_iters}")
        if (self.mode == "sketch" and self.momentum_dampening is True
                and not self.allow_unstable_sketch_dampening):
            raise ValueError(
                "momentum_dampening=True with mode='sketch' is a known-"
                "divergent combination (it re-sketches NOISY momentum "
                "estimates each round). FetchSGD Alg 1 does not mask "
                "sketched momentum: use momentum_dampening=None/False, or "
                "set allow_unstable_sketch_dampening=True for parity "
                "experiments."
            )
        if self.error_decay != 1.0 and self.error_type != "virtual":
            raise ValueError(
                "error_decay only acts on the server-side virtual error bank "
                f"(error_type='virtual'); with error_type={self.error_type!r}"
                " it would be a silent no-op"
            )
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got "
                             f"{self.model!r}")
        if self.dataset_name not in MODEL_DATASETS[self.model]:
            raise ValueError(
                f"dataset_name={self.dataset_name!r} with model="
                f"{self.model!r}: {self.model} trains on one of "
                f"{MODEL_DATASETS[self.model]}")
        if self.label_noise < 0.0 or self.label_noise > 1.0:
            raise ValueError(
                f"label_noise must be in [0, 1], got {self.label_noise}")
        if self.num_classes is not None and self.num_classes < 1:
            raise ValueError(
                f"num_classes must be >= 1 (or None), got {self.num_classes}")
        if self.device_data_max_mb < 0:
            raise ValueError(f"device_data_max_mb must be >= 0, got "
                             f"{self.device_data_max_mb}")
        if self.num_candidates < 1 or self.max_history < 0:
            raise ValueError(
                f"num_candidates must be >= 1 and max_history >= 0, got "
                f"{self.num_candidates} and {self.max_history}")
        if self.max_seq_len < 2:
            raise ValueError(
                f"max_seq_len must be >= 2 (the next-token shift), got "
                f"{self.max_seq_len}")
        if self.synthetic_variant not in ("flat", "concentrated",
                                          "concentrated_v2"):
            raise ValueError(
                "synthetic_variant must be flat|concentrated|concentrated_v2,"
                f" got {self.synthetic_variant!r}"
            )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda|cpu, got {self.device!r}")
        if self.num_workers % self.num_devices != 0:
            raise ValueError(
                "num_workers must be divisible by num_devices "
                f"({self.num_workers} % {self.num_devices} != 0): each "
                "device computes num_workers / num_devices clients. To "
                "model partial participation, keep the round shape and "
                "mask clients out with the fedsim environment instead "
                "(--availability bernoulli --dropout_prob p, or --chaos "
                "'dropout@p')")
        if self.num_clients < self.num_workers:
            raise ValueError("num_clients must be >= num_workers")
        if self.max_rounds < 0:
            raise ValueError(f"max_rounds must be >= 0, got {self.max_rounds}")
        self._validate_fedsim()
        self._validate_sketch_fused_bwd()
        self._validate_dp()
        self._validate_checkpoint()

    def _validate_client_store(self) -> None:
        """The client-state placement flags (clientstore/), as the
        reference checks them. The deprecated ``offload_client_state``
        becomes ``client_store='host'`` here, before any later check reads
        ``client_state_hosted``."""
        if self.client_store not in CLIENT_STORES:
            raise ValueError(f"client_store must be one of {CLIENT_STORES},"
                             f" got {self.client_store!r}")
        if self.offload_client_state:
            import warnings

            warnings.warn(
                "offload_client_state is deprecated: the whole-store "
                "offload became the per-cohort client-state store — use "
                "--client_store host (identical semantics at whole-store "
                "granularity; adds mmap backing and the LRU device cache)",
                DeprecationWarning, stacklevel=4)
            if self.client_store == "device":
                object.__setattr__(self, "client_store", "host")
        if self.client_store_cache_rows < 0:
            raise ValueError(
                f"client_store_cache_rows must be >= 0 (0 = no cache), got "
                f"{self.client_store_cache_rows}")
        if self.client_store == "device":
            if self.client_store_cache_rows:
                raise ValueError(
                    "client_store_cache_rows caches host-store cohort rows "
                    "on device; with client_store='device' the whole bank "
                    "already lives in device memory — drop the cache flag "
                    "or pick --client_store host|mmap")
            if self.client_store_path:
                raise ValueError(
                    "client_store_path backs the mmap store; with "
                    f"client_store={self.client_store!r} it would be "
                    "silently ignored — use --client_store mmap")
        if self.client_store == "host" and self.client_store_path:
            raise ValueError(
                "client_store_path backs the mmap store; the host store is "
                "a RAM bank — use --client_store mmap to persist to "
                f"{self.client_store_path!r}")
        if self.client_state_hosted and self.fsdp:
            raise ValueError(
                "client_store='host'/'mmap' streams per-cohort rows through "
                "the replicated round function; the FSDP round shards server "
                "state instead (local modes host their memory wall via "
                "--client_store, server modes via --fsdp) — run one or the "
                "other")

    def _validate_fedsim(self) -> None:
        """The reference's fedsim knob checks, plus the chaos kinds the
        port does not run."""
        if self.availability not in AVAILABILITY_MODELS:
            raise ValueError(
                f"availability must be one of {AVAILABILITY_MODELS}, got "
                f"{self.availability!r}")
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError(
                f"dropout_prob must be in [0, 1), got {self.dropout_prob} "
                "(at 1.0 every client drops every round and nothing ever "
                "trains)")
        if self.dropout_prob > 0 and self.availability == "always":
            raise ValueError(
                "dropout_prob > 0 has no effect with availability="
                "'always'; pick a model that uses it (bernoulli|sine|"
                "cohort), or schedule it via --chaos 'dropout@p'")
        if self.availability_period < 1:
            raise ValueError(f"availability_period must be >= 1, got "
                             f"{self.availability_period}")
        if self.num_cohorts < 1:
            raise ValueError(f"num_cohorts must be >= 1, got "
                             f"{self.num_cohorts}")
        if not self.arrival_rate > 0:  # rejects 0, negatives, and NaN
            raise ValueError(
                f"arrival_rate must be > 0 (rate=inf is the degenerate "
                f"everyone-arrives-instantly case), got {self.arrival_rate}")
        if self.chaos:
            from commefficient_tpu_torch.fedsim.faults import (
                PORTED_KINDS,
                parse_chaos,
            )

            for ev in parse_chaos(self.chaos):
                if ev.kind not in PORTED_KINDS:
                    raise ValueError(
                        f"chaos kind {ev.kind!r} is not ported yet: the "
                        "elastic fleet needs the per-width round programs "
                        "(ROADMAP A11, item A.1.4); the port runs "
                        f"{PORTED_KINDS}")

    def _validate_resilience(self) -> None:
        """The reference's checks of the self-healing flags (resilience/):
        the values here; what needs the run length or the session at the
        train entry and the session build."""
        if self.recover_policy not in RECOVER_POLICIES:
            raise ValueError(
                f"recover_policy must be one of {RECOVER_POLICIES}, got "
                f"{self.recover_policy!r}")
        if self.snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1 round, got "
                f"{self.snapshot_every}")
        if self.max_recoveries < 1:
            raise ValueError(
                f"max_recoveries must be >= 1, got {self.max_recoveries} "
                "(use recover_policy='none' to disable recovery entirely)")
        if self.recover_policy == "none":
            return
        if self.telemetry_level < 1:
            raise ValueError(
                f"recover_policy={self.recover_policy!r} recovers from the "
                "flight recorder's DivergenceError, which only fires at "
                "--telemetry_level >= 1 (the round's non-finite sentinel "
                "and the drain-time check) — at level 0 a divergence is "
                "never detected, so the policy would silently never act")
        if self.recover_policy == "demote":
            if not self.control_enabled or not self.ladder:
                raise ValueError(
                    "recover_policy='demote' descends the control/ "
                    "compression ladder — configure a controller with a "
                    'ladder (e.g. --control_policy fixed --ladder '
                    '"k=60000,30000")')
            from commefficient_tpu_torch.control.ladder import parse_ladder

            if len(parse_ladder(self.ladder)) < 2:
                raise ValueError(
                    "recover_policy='demote' needs a ladder with >= 2 "
                    "rungs to demote between")
        if self.recover_policy == "skip_clients" and not self.fedsim_enabled:
            raise ValueError(
                "recover_policy='skip_clients' masks blacklisted clients "
                "through the fedsim participation mask, but this config "
                "masks nothing (availability='always', no chaos) — enable "
                "fedsim (e.g. --availability bernoulli) or pick another "
                "policy")

    def _validate_aggregate(self) -> None:
        """The reference's checks of ``aggregate`` (sparse aggregation,
        ``ops/collectives``; resolved per mode by
        ``Compressor.use_sparse_aggregate``)."""
        if self.aggregate not in ("auto", "dense", "sparse"):
            raise ValueError(
                "aggregate must be auto|dense|sparse, got "
                f"{self.aggregate!r}")
        if self.aggregate != "sparse":
            return
        if self.mode not in ("local_topk", "true_topk", "sketch"):
            raise ValueError(
                "aggregate='sparse' exchanges <=k-sparse (idx, val) pairs "
                f"over the worker group; mode={self.mode!r} has no sparse "
                "transmit. Leave aggregate='auto' (a no-op there).")
        if self.fsdp:
            raise ValueError(
                "aggregate='sparse' targets the replicated round; the FSDP "
                "round already reduce-scatters O(D/W) per device and "
                "exchanges only W*k candidate pairs. Leave "
                "aggregate='auto' under fsdp=True.")
        if self.mode == "true_topk" and self.topk_method != "threshold":
            raise ValueError(
                "aggregate='sparse' with mode='true_topk' selects the "
                "global top-<=k with the sharded threshold selection; set "
                "topk_method='threshold', or leave aggregate='auto' to "
                f"keep the dense sum with topk_method={self.topk_method!r}")
        if self.mode == "sketch":
            if self.topk_method != "threshold":
                raise ValueError(
                    "aggregate='sparse' with mode='sketch' rides the "
                    "sharded decode's pair exchange for the error-feedback "
                    "re-sketch; set topk_method='threshold' (the sharded "
                    "decode's requirement), or leave aggregate='auto'")
            if self.sketch_decode == "dense":
                raise ValueError(
                    "aggregate='sparse' with mode='sketch' requires the "
                    "sharded server decode (its pair exchange is what the "
                    "error-feedback re-sketch rides); remove "
                    "sketch_decode='dense' or leave aggregate='auto'")

    def _validate_overlap_collectives(self) -> None:
        """Only the value set, as in the reference: the layerwise overlap
        is a scheduling choice that composes with every mode (a path
        without a segmentable collective runs as with 'none')."""
        if self.overlap_collectives not in ("none", "layerwise"):
            raise ValueError(
                "overlap_collectives must be 'none' (monolithic "
                "aggregation collectives) or 'layerwise' (segmented "
                "collectives issued as the backward produces them), got "
                f"{self.overlap_collectives!r}")

    def _validate_pipeline(self) -> None:
        """The reference's pipeline_depth checks and its exclusion of
        scan_rounds with the control plane. They run before the refusals
        of unported knobs, so depth or the control plane with scan_rounds,
        or depth with fleet events (both still refused, naming A11), gives
        the reference's message."""
        if self.scan_rounds > 1 and self.control_enabled:
            raise ValueError(
                "scan_rounds > 1 is mutually exclusive with the control "
                "plane: the controller decides immediately-pre-dispatch "
                "per ROUND, and a scanned block admits no host decision "
                "between its rounds — run one or the other")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0 (0 = synchronous), got "
                f"{self.pipeline_depth}")
        if self.pipeline_depth == 0:
            return
        if self.scan_rounds > 1:
            raise ValueError(
                "scan_rounds > 1 already stages the whole epoch's sampler "
                "indices up front (a superset of the prefetcher's depth-K "
                "window on the index path) — drop pipeline_depth")
        if self.chaos:
            from commefficient_tpu_torch.fedsim.faults import (
                FLEET_KINDS,
                parse_chaos,
            )

            if any(ev.kind in FLEET_KINDS for ev in parse_chaos(self.chaos)):
                raise ValueError(
                    "fleet events are incompatible with pipeline_depth > 0 "
                    "for now: the prefetcher stages round payloads at the "
                    "base width ahead of the resize decision point — run "
                    "synchronous rounds with the fleet plan")

    def _validate_asyncfed(self) -> None:
        """The reference's checks of the buffered-asynchronous flags
        (asyncfed/, its messages): the engine launches overlapping cohorts
        of per-client transmit rows and applies a staleness-weighted
        update once K of them have arrived, so a setting that assumes one
        cohort a server version, or that never forms the per-client rows,
        is refused here. They run before the refusals of unported knobs,
        so ``scan_rounds`` with it gives the reference's message."""
        if self.async_buffer < 0:
            raise ValueError(
                f"async_buffer must be >= 0 (0 = synchronous barrier "
                f"rounds), got {self.async_buffer}")
        if self.async_concurrency < 1:
            raise ValueError(
                f"async_concurrency must be >= 1, got "
                f"{self.async_concurrency}")
        if self.staleness_exponent < 0:
            raise ValueError(
                f"staleness_exponent must be >= 0 ((1+s)^-alpha is a "
                f"DISCOUNT; a negative alpha would amplify stale "
                f"contributions), got {self.staleness_exponent}")
        if self.async_buffer == 0:
            if self.async_concurrency != 1:
                raise ValueError(
                    "async_concurrency > 1 has no effect without "
                    "--async_buffer K; set async_buffer > 0 to enable the "
                    "asyncfed engine")
            if self.staleness_exponent != 0.0:
                raise ValueError(
                    "staleness_exponent has no effect without "
                    "--async_buffer K: synchronous rounds have staleness 0 "
                    "by construction")
            if self.async_double_buffer:
                raise ValueError(
                    "async_double_buffer defers the asyncfed apply fence "
                    "behind the next cohort launches, which only exist "
                    "with --async_buffer K; set async_buffer > 0 to "
                    "enable the asyncfed engine")
            return
        if self.async_buffer > self.num_workers:
            raise ValueError(
                f"async_buffer must be <= num_workers ("
                f"{self.num_workers}): an update consumes at most one full "
                f"cohort's W slots per in-flight cohort, and K > W would "
                f"just wait for the next cohort anyway — raise "
                f"async_concurrency instead, got {self.async_buffer}")
        if self.fuse_clients or self.sketch_fused_bwd:
            raise ValueError(
                "async_buffer > 0 needs PER-CLIENT transmit rows (each "
                "arrival is weighted by its own staleness/live factor); "
                "the fused flattened-batch paths produce one device-level "
                "gradient — drop fuse_clients/sketch_fused_bwd")
        # the deprecated alias becomes client_store='host' only later, in
        # _validate_client_store
        if (self.client_state_hosted or self.offload_client_state
                or self.fsdp):
            raise ValueError(
                "async_buffer > 0 currently requires HBM-resident client "
                "state on the replicated engine (--client_store host|mmap "
                "and fsdp run their own round builders)")
        if self.scan_rounds > 1:
            raise ValueError(
                "async_buffer > 0 is mutually exclusive with "
                "scan_rounds > 1: a scanned block admits no host-side "
                "arrival buffering between its rounds")
        if self.pipeline_depth > 0:
            raise ValueError(
                "async_buffer > 0 supersedes pipeline_depth: the asyncfed "
                "engine owns its own cohort prefetch window "
                "(async_concurrency cohorts in flight) — drop "
                "pipeline_depth")
        if self.preempt_signals or "preempt@" in self.chaos:
            raise ValueError(
                "async_buffer > 0 cannot yet honor round-granular "
                "preemption: in-flight cohorts would be abandoned "
                "mid-arrival — disable preempt_signals / the preempt@ "
                "chaos event")

    def _validate_dp(self) -> None:
        if self.dp_noise_multiplier < 0:
            raise ValueError(f"dp_noise_multiplier must be >= 0, got "
                             f"{self.dp_noise_multiplier}")
        if self.dp_noise_multiplier > 0 and self.max_grad_norm is None:
            raise ValueError(
                "dp_noise_multiplier > 0 needs max_grad_norm: the noise's "
                "std is dp_noise_multiplier * max_grad_norm, the clip "
                "bound of each client's gradient, and the reference adds "
                "no noise without a clip — set --max_grad_norm, or leave "
                "dp_noise_multiplier at 0")

    def _validate_sketch_fused_bwd(self) -> None:
        """The sketch-fused backward produces the gradient directly as a
        table, so it exists only on the fused flattened-batch path with
        nothing per client configured (the reference's six refusals)."""
        if not self.sketch_fused_bwd:
            return
        if self.mode != "sketch":
            raise ValueError(
                "sketch_fused_bwd sketches per-leaf cotangents into the "
                f"CountSketch table; mode={self.mode!r} has no table — "
                "drop the flag or use mode='sketch'")
        if not self.fuse_clients:
            raise ValueError(
                "sketch_fused_bwd needs the fused flattened-batch path "
                "(ONE gradient per device -> one table); with "
                "fuse_clients=False each client's grad would pay its own "
                "sketch — set fuse_clients=True")
        if self.local_momentum > 0:
            raise ValueError(
                "sketch_fused_bwd is incompatible with local_momentum: "
                "per-client velocity needs the dense per-client gradient "
                "the fused backward never materializes")
        if self.max_grad_norm is not None:
            raise ValueError(
                "sketch_fused_bwd is incompatible with max_grad_norm "
                "(clipping also forces the per-client path; the "
                "fused-batch gate already excludes it)")
        if self.dp_noise_multiplier > 0:
            raise ValueError(
                "sketch_fused_bwd is incompatible with DP noise: the "
                "noise is a [D]-vector draw, which is exactly the "
                "transient the fused backward exists to avoid")
        if self.fedsim_enabled:
            raise ValueError(
                "sketch_fused_bwd needs the fused flattened-batch path, "
                "and fedsim masking is inherently per-client (it forces "
                "the per-client path) — run one or the other")

    def _validate_control(self) -> None:
        """The reference's checks of the control plane's flags. The rungs'
        cost order needs the realized compressor geometry and is checked
        at session build, the schedule's rounds against the run length by
        the controller."""
        from commefficient_tpu_torch.control.policy import (
            CONTROL_POLICIES,
            parse_schedule,
        )

        if self.control_policy not in CONTROL_POLICIES:
            raise ValueError(
                f"control_policy must be one of {CONTROL_POLICIES}, got "
                f"{self.control_policy!r}")
        rungs = ()
        if self.ladder:
            from commefficient_tpu_torch.control.ladder import (
                LADDER_FIELDS,
                parse_ladder,
            )

            rungs = parse_ladder(self.ladder)  # the grammar on a bad one
            if self.control_policy == "none":
                raise ValueError(
                    "a ladder without a controller would silently never "
                    "switch — set control_policy (fixed | budget_pacing | "
                    "ef_feedback), or drop --ladder")
            if self.mode != "powersgd" and any("powersgd_rank" in r
                                               for r in rungs):
                raise ValueError(
                    f"ladder field powersgd_rank has no effect with "
                    f"mode={self.mode!r} — the rung switch would be a "
                    "silent no-op; ladder fields must act on the active "
                    f"mode ({LADDER_FIELDS} minus the inert ones)")
            if self.mode != "sketch" and any("num_cols" in r for r in rungs):
                raise ValueError(
                    f"ladder field num_cols has no effect with "
                    f"mode={self.mode!r} (no sketch table) — the rung "
                    "switch would be a silent no-op")
            if (self.mode in ("uncompressed", "fedavg")
                    and not self.do_topk_down
                    and any("k" in r for r in rungs)):
                # with do_topk_down, k sizes the downlink's top-k: a k
                # ladder is then a real downlink-budget ladder
                raise ValueError(
                    f"ladder field k has no effect with mode={self.mode!r} "
                    "(dense transmit, no top-k extraction) — the rung "
                    "switch would be a silent no-op")
        if self.control_policy == "ef_feedback":
            if len(rungs) < 2:
                raise ValueError(
                    "control_policy='ef_feedback' needs a ladder with >= 2 "
                    "rungs to move between — pass --ladder (e.g. "
                    '"k=60000,30000,10000")')
            if self.telemetry_level < 1:
                raise ValueError(
                    "control_policy='ef_feedback' consumes the drained "
                    "diag/ef_residual_norm telemetry — set "
                    "--telemetry_level >= 1 (>= 2 if control_fidelity_max "
                    "is used)")
            if not self.control_ef_up > self.control_ef_down:
                raise ValueError(
                    f"control_ef_up ({self.control_ef_up}) must exceed "
                    f"control_ef_down ({self.control_ef_down}): the dead "
                    "band between them is what stops threshold flapping")
        if self.control_policy == "staleness_aware":
            if not self.asyncfed_enabled:
                raise ValueError(
                    "control_policy='staleness_aware' acts on the drained "
                    "async/staleness_mean and async/buffer_fill scalars, "
                    "which only the asyncfed engine emits — set "
                    "--async_buffer K (synchronous rounds have staleness 0 "
                    "by construction, so the policy would never act)")
            if len(rungs) < 2:
                raise ValueError(
                    "control_policy='staleness_aware' walks the "
                    "compression ladder by observed staleness — pass "
                    '--ladder with >= 2 rungs (e.g. "k=60000,30000")')
            if self.telemetry_level < 1:
                raise ValueError(
                    "control_policy='staleness_aware' consumes drained "
                    "telemetry scalars — set --telemetry_level >= 1")
            if not self.control_staleness_hi > self.control_staleness_lo:
                raise ValueError(
                    f"control_staleness_hi ({self.control_staleness_hi}) "
                    f"must exceed control_staleness_lo "
                    f"({self.control_staleness_lo}): the dead band between "
                    "them is what stops threshold flapping")
            if not self.control_fill_hi > self.control_fill_lo >= 0:
                raise ValueError(
                    f"control_fill_hi ({self.control_fill_hi}) must exceed "
                    f"control_fill_lo ({self.control_fill_lo}) >= 0 — the "
                    "normalized backlog band the K/C re-tune targets")
        if self.control_policy == "fixed":
            sched = parse_schedule(self.control_schedule)
            if not sched:
                raise ValueError(
                    "control_policy='fixed' needs --control_schedule "
                    '(e.g. "0-99=2,100-=0")')
            n_rungs = max(len(rungs), 1)
            for start, end, rung in sched:
                if rung >= n_rungs:
                    raise ValueError(
                        f"control_schedule names rung {rung}, but the "
                        f"ladder has {n_rungs} rung(s) (indices 0.."
                        f"{n_rungs - 1})")
        elif self.control_schedule:
            raise ValueError(
                "control_schedule only drives control_policy='fixed'; "
                f"with {self.control_policy!r} it would be silently ignored")
        if self.budget_mb < 0:
            raise ValueError(f"budget_mb must be >= 0, got {self.budget_mb}")
        if self.control_policy == "budget_pacing" and not self.budget_mb > 0:
            raise ValueError(
                "control_policy='budget_pacing' paces against --budget_mb; "
                "set it > 0")
        if self.budget_mb > 0 and self.control_policy == "none":
            raise ValueError(
                "budget_mb is enforced by the control plane; with "
                "control_policy='none' nothing would watch it — use "
                "control_policy='budget_pacing' (a ladder is optional: "
                "without one the budget is a pure hard cap)")
        if self.control_hysteresis < 1:
            raise ValueError(
                f"control_hysteresis must be >= 1 round, got "
                f"{self.control_hysteresis}")

    def _validate_checkpoint(self) -> None:
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0 (0 = off), got "
                             f"{self.checkpoint_every}")
        if not self.checkpoint_dir and (self.checkpoint_every
                                        or self.resume):
            raise ValueError(
                "checkpoint_every and resume need checkpoint_dir: without "
                "a directory nothing is saved or restored, and the port "
                "runs no setting that would be ignored")

    @property
    def fedsim_enabled(self) -> bool:
        """True when any masking/chaos source is on (the reference's
        gate): the round then masks its clients by the fedsim
        environment."""
        return self.availability != "always" or bool(self.chaos)

    @property
    def control_enabled(self) -> bool:
        """True when the control plane is built (a session of the ladder's
        rungs and a controller); False keeps the session one rung over
        this config, building what it built before."""
        return self.control_policy != "none"

    @property
    def recovery_enabled(self) -> bool:
        """True when the divergence rollback-and-recover machinery is built
        (resilience/'s vault and manager); False builds nothing of it. The
        preemption guard has its own gates: ``preempt_signals`` or a
        ``preempt@R`` chaos event."""
        return self.recover_policy != "none"

    @property
    def client_state_hosted(self) -> bool:
        """True when the per-client rows live outside ``FedState`` (a
        clientstore/ host or mmap bank): the round takes the cohort's rows
        as arguments and returns its new rows. False keeps the banks on
        the device and builds nothing of clientstore/."""
        return self.client_store in ("host", "mmap")

    @property
    def pipeline_enabled(self) -> bool:
        """True when the runner builds the pipelined round engine
        (``pipeline_depth > 0``); at 0 nothing of ``pipeline/`` is
        built."""
        return self.pipeline_depth > 0

    @property
    def asyncfed_enabled(self) -> bool:
        """True when the runner builds the buffered-asynchronous engine
        (asyncfed/, ``async_buffer > 0``); False builds nothing of it."""
        return self.async_buffer > 0

    @property
    def sampler_batch_size(self) -> int:
        """Samples the sampler draws per client per round: a fedavg round
        batch carries ``round_microbatches`` microbatches of
        ``local_batch_size`` each."""
        return self.local_batch_size * (self.round_microbatches or 1)

    @property
    def round_microbatches(self) -> int:
        """Microbatches per client per round: ``num_local_iters`` for
        fedavg's ``[W, L, B, ...]`` batch convention, else 0 (flat
        ``[W, B, ...]`` batches)."""
        return self.num_local_iters if self.mode == "fedavg" else 0

    @property
    def resolved_num_classes(self) -> int:
        """num_classes if set, else derived from dataset_name."""
        if self.num_classes is not None:
            return self.num_classes
        return {"cifar10": 10, "cifar100": 100, "femnist": 62,
                "imagenet": 1000}.get(self.dataset_name, 10)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _add_flags(p: argparse.ArgumentParser) -> None:
    """One flag per Config field, the reference's names and parsing."""
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default
        ann = str(f.type)
        if isinstance(default, bool) or ann == "bool":
            p.add_argument(name, type=_bool, nargs="?", const=True,
                           default=default)
        elif "Optional" in ann:
            if "bool" in ann:  # tri-state: None (auto) | true | false
                p.add_argument(name, type=_bool, nargs="?", const=True,
                               default=default)
            else:
                inner = float if "float" in ann else (
                    int if "int" in ann else str)

                def opt(s, _inner=inner):
                    return None if s.lower() in ("none", "null") else _inner(s)

                p.add_argument(name, type=opt, default=default)
        else:
            p.add_argument(name, type=type(default), default=default)


def parse_args(argv=None, defaults=None, **overrides) -> Config:
    """CLI -> Config. ``defaults`` changes parser defaults; ``overrides``
    win over the CLI (the reference's contract)."""
    p = argparse.ArgumentParser(description="commefficient_tpu_torch")
    _add_flags(p)
    if defaults:
        p.set_defaults(**defaults)
    d = vars(p.parse_args(argv))
    d.update(overrides)
    return Config(**d)

"""Typed configuration — the port's own copy of the reference's ``Config``.

Field names, defaults and CLI flags are the reference's
(``commefficient_tpu/utils/config.py``) for every knob this slice of the
port runs, so a command line moves between the two packages unchanged. A
knob the port does not run yet keeps its reference name and default and is
REFUSED at construction with a ``ValueError`` naming the blocker and the
ROADMAP item that lifts it — nothing runs quietly with a setting ignored.

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

# the modes this slice ports; the reference registers six
MODES = ("uncompressed", "sketch")
REFERENCE_MODES = ("uncompressed", "sketch", "true_topk", "local_topk",
                   "fedavg", "powersgd")
ERROR_TYPES = ("none", "local", "virtual")

# field -> ROADMAP item that ports it; any value but the default is refused
_UNPORTED = {
    "local_momentum": "per-client momentum banks (ROADMAP A7)",
    "dp_noise_multiplier": "worker-side DP noise (ROADMAP A8; hazard C.4)",
    "sketch_fused_bwd": "the sketch-fused backward (ROADMAP A10)",
    "telemetry_level": "telemetry/ diagnostics (ROADMAP A12)",
    "availability": "fedsim participation masks (ROADMAP A8)",
    "chaos": "fedsim chaos plans (ROADMAP A8)",
    "control_policy": "the control/ compression ladder (ROADMAP A11)",
    "ladder": "the control/ compression ladder (ROADMAP A11)",
    "checkpoint_every": "checkpoint/resume (ROADMAP A8)",
    "resume": "checkpoint/resume (ROADMAP A8)",
    "recover_policy": "resilience/ rollback (ROADMAP A11)",
    "pipeline_depth": "the pipelined round engine (ROADMAP A11)",
}


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

    # --- momentum / error feedback ---
    virtual_momentum: float = 0.0  # server-side momentum factor rho
    local_momentum: float = 0.0
    error_type: str = "none"
    error_decay: float = 1.0
    # None = AUTO (False for sketch: FetchSGD Alg 1 does not mask sketched
    # momentum); the port refuses True for sketch (ROADMAP A7)
    momentum_dampening: Optional[bool] = None

    # --- federation shape ---
    num_clients: int = 16
    num_workers: int = 8
    num_devices: int = 1
    local_batch_size: int = 8
    iid: bool = True

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
    compute_dtype: str = "mixed"  # mixed (bf16 model compute) | float32
    fuse_clients: bool = False

    # --- CountSketch ---
    sketch_dtype: str = "float32"
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

    # --- refused until their ROADMAP item lands (see _UNPORTED) ---
    dp_noise_multiplier: float = 0.0
    sketch_fused_bwd: bool = False
    telemetry_level: int = 0
    availability: str = "always"
    chaos: str = ""
    control_policy: str = "none"
    ladder: str = ""
    checkpoint_every: int = 0
    resume: bool = False
    recover_policy: str = "none"
    pipeline_depth: int = 0

    seed: int = 42

    # --- the port's own ---
    device: str = "cuda"  # "cuda" | "cpu"; cuda raises when absent
    max_rounds: int = 0  # > 0: stop after this many rounds, then evaluate

    def __post_init__(self):
        if self.mode not in REFERENCE_MODES:
            raise ValueError(
                f"mode must be one of {REFERENCE_MODES}, got {self.mode!r}"
            )
        if self.mode not in MODES:
            raise ValueError(
                f"mode={self.mode!r} is not ported yet: the port runs "
                f"{MODES} (ROADMAP A7 ports the remaining compressors)"
            )
        if self.error_type not in ERROR_TYPES:
            raise ValueError(
                f"error_type must be one of {ERROR_TYPES}, got "
                f"{self.error_type!r}"
            )
        for name, blocker in _UNPORTED.items():
            default = Config.__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} is not ported yet: "
                    f"{blocker}; leave it at {default!r}"
                )
        if self.num_devices != 1:
            raise ValueError(
                f"num_devices={self.num_devices}: the port runs one device "
                "(ROADMAP A9 brings torch.distributed and the sharded decode)"
            )
        if self.sketch_decode not in ("auto", "dense", "sharded"):
            raise ValueError(
                "sketch_decode must be auto|dense|sharded, got "
                f"{self.sketch_decode!r}"
            )
        if self.sketch_decode == "sharded":
            raise ValueError(
                "sketch_decode='sharded' is not ported yet: it needs the "
                "estimate_at kernel (ROADMAP B4/B5) and a multi-GPU mesh "
                "(ROADMAP A9); 'auto' is the dense decode on one device"
            )
        if self.topk_method not in ("exact", "threshold", "approx"):
            raise ValueError(
                "topk_method must be exact|threshold|approx, got "
                f"{self.topk_method!r}"
            )
        if self.topk_method != "exact":
            raise ValueError(
                f"topk_method={self.topk_method!r} is not ported yet: only "
                "'exact' (torch.topk with lax.top_k's tie rule) runs "
                "(ROADMAP A7 lists the threshold/approx selections)"
            )
        if self.num_blocks != 1:
            raise ValueError(
                f"num_blocks={self.num_blocks} is not ported yet: the "
                "blockwise gather estimate is listed under ROADMAP A7"
            )
        for name in ("sketch_dtype", "sketch_table_dtype"):
            v = getattr(self, name)
            if v not in ("float32", "bfloat16"):
                raise ValueError(f"{name} must be float32|bfloat16, got {v!r}")
            if v != "float32":
                raise ValueError(
                    f"{name}={v!r} is not ported yet: bf16 sketch storage "
                    "and operands come with the GPT-2 path (ROADMAP A10)"
                )
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
        if self.compute_dtype == "bfloat16":
            raise ValueError(
                "compute_dtype='bfloat16' is not ported yet (a no-op for "
                "ResNet-9 in the reference; it matters for GPT-2, ROADMAP A10)"
            )
        if self.fuse_clients:
            raise ValueError(
                "fuse_clients=True is not ported yet: the port computes the "
                "per-client gradients one client at a time (ROADMAP A7)"
            )
        if self.mode == "sketch" and self.momentum_dampening:
            raise ValueError(
                "momentum_dampening=True with mode='sketch' is not ported: "
                "it needs estimate_at + sketch_sparse dampening (ROADMAP A7), "
                "and the reference gates it as divergent"
            )
        if self.error_decay != 1.0 and self.error_type != "virtual":
            raise ValueError(
                "error_decay only acts on the server-side virtual error bank "
                f"(error_type='virtual'); with error_type={self.error_type!r}"
                " it would be a silent no-op"
            )
        if self.model != "resnet9":
            raise ValueError(
                f"model={self.model!r} is not ported yet: the port runs "
                "resnet9 (ROADMAP A10/A13 port GPT-2 and FixupResNet-50)"
            )
        if self.dataset_name != "cifar10":
            raise ValueError(
                f"dataset_name={self.dataset_name!r} is not ported yet: the "
                "port runs cifar10 (ROADMAP A13 ports the other datasets)"
            )
        if self.synthetic_variant not in ("flat", "concentrated",
                                          "concentrated_v2"):
            raise ValueError(
                "synthetic_variant must be flat|concentrated|concentrated_v2,"
                f" got {self.synthetic_variant!r}"
            )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda|cpu, got {self.device!r}")
        if self.num_workers % self.num_devices != 0:
            raise ValueError("num_workers must be divisible by num_devices")
        if self.num_clients < self.num_workers:
            raise ValueError("num_clients must be >= num_workers")
        if self.max_rounds < 0:
            raise ValueError(f"max_rounds must be >= 0, got {self.max_rounds}")

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

"""Small cells for the CPU tests: the configurations' families at tiny
widths, with the traffic's shapes cut to match."""

import copy
import json
from pathlib import Path

from benchmark.harness.spec import Cell

BENCH = Path(__file__).resolve().parents[1]
WORKLOADS = ("gpt2.sketch", "gpt2.uncompressed", "resnet9.sketch_scan4",
             "resnet9.uncompressed_scan4")
# the limits at these sizes, from CPU readings on seeds 3, 4, 5 and
# 2**31 + 9 of the program (bf16), its fp8 control and its half-batch
# fault, per cell in WORKLOADS' order: program state_gap at most 0.015 /
# 0.043 / 0.084 (0.084 on SEED) / 0.085, the control at least 0.073 /
# 0.50 / 0.094 (0.151 on SEED) / 0.128; the half batch's loss_gap at
# least 1.7e-3 / 1.9e-3 / 0.015 / 0.057 against the program's 6.6e-5 /
# 7.4e-5 / 1.7e-3 / 1.4e-3; the program's delta_gap at most 0.15 / 0.037
# / 0.19 / 0.10, where a state left unchanged reads 1
TINY_LIMITS = {
    "gpt2.sketch": {"loss_gap": 1e-3, "state_gap": 0.04, "delta_gap": 0.5},
    "gpt2.uncompressed": {"loss_gap": 1e-3, "state_gap": 0.15,
                          "delta_gap": 0.3},
    "resnet9.sketch_scan4": {"loss_gap": 0.008, "state_gap": 0.12,
                             "delta_gap": 0.6},
    "resnet9.uncompressed_scan4": {"loss_gap": 0.015, "state_gap": 0.11,
                                   "delta_gap": 0.4},
}
SEED = 2**31 + 9


def _load(path):
    return json.loads((BENCH / path).read_text())


def tiny(workload: str) -> Cell:
    """``workload``'s traffic and configuration at a size the CPU runs in
    seconds, with its own limits."""
    tr = copy.deepcopy(_load(f"workloads/{workload}.json"))
    if workload.startswith("gpt2"):
        cfg = _load("configs/gpt2_small_personachat.json")
        cfg.update(program_model="gpt2_tiny", vocab_size=512,
                   n_positions=128, n_ctx=128, n_embd=64, n_layer=2,
                   n_head=4)
        tr["round"].update(num_workers=4, local_batch_size=2)
        tr["data"].update(num_clients=16, dialogs_per_client=8,
                          max_seq_len=128)
        tr["warmup_rounds"] = 4
    else:
        cfg = _load("configs/resnet9_cifar10.json")
        cfg.update(width=16)
        tr["round"].update(num_workers=4, local_batch_size=8)
        tr["data"].update(num_images=544, num_clients=8)
        tr["warmup_rounds"] = 40
    if tr["optimizer"]["mode"] == "sketch":  # d / c about 20, stable
        tr["optimizer"].update(num_cols=8000 if workload.startswith("gpt2")
                               else 20000, k=400)
    tr["limits"] = dict(TINY_LIMITS[workload])
    return Cell(workload, cfg, tr, [], [])

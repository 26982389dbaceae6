"""What a cell is, read from files by name: ``BENCHMARK.json``'s entry,
the configuration's file (``benchmark/configs/<name>.json``), the traffic
file (``benchmark/workloads/<cell>.json``) and the reader of each metric
the cell reports (``benchmark/metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _reports(metric: dict, cell: str, e2e: Dict[str, dict]) -> bool:
    """Whether a metric belongs in ``cell``'s line: its ``workloads``
    name the cell, or, without that key, the cell reports the end-to-end
    metric it moves (or, for an end-to-end metric, every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or _reports(e2e[moves], cell, e2e)


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(bench_file).read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{w['traffic']}.json")
                         .read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return Cell(name, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name, e2e)],
                [m for m in bench["per_layer"] if _reports(m, name, e2e)])


def reader(metric: str):
    """The module ``benchmark/metrics/<metric>.py``; its ``read(ctx)``
    returns the metric's value, or None where it found nothing to read."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

"""The harness finds every cell, configuration, traffic mix and metric
by its name in ``BENCHMARK.json``, and the file keeps the benchmark's
contract: its keys, names, units, bounds and per-cell metrics."""

import json
import re

import pytest

from benchmark.harness.spec import BENCH, ROOT, load_cell, reader

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(conf):
    body = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("benchmark/configs/")
    assert body["reduced"] == conf["reduced"]
    assert all(k in body for k in conf["reduced"])
    assert body["source"] == conf["source"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name_with_its_metrics(name):
    cell = load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    layer = {m["name"] for m in cell.per_layer}
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    per_round = cell.traffic["round"]["scan_rounds"] <= 1
    assert ("round_ms.per_round" in e2e) == per_round
    assert ("round_ms" in e2e) == (not per_round)
    assert ("round_ms_p95" in layer) == per_round
    assert bool({"countsketch_roofline", "countsketch_roofline.per_round"}
                & layer) == (cell.traffic["optimizer"]["mode"] == "sketch")
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert set(cell.traffic["limits"]) == {"loss_gap", "state_gap",
                                           "delta_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert (BENCH / "metrics" / f"{metric}.py").is_file()
    assert callable(reader(metric).read)


def test_per_layer_workloads_name_cells():
    for m in METRICS:
        for w in m.get("workloads", []):
            assert w in CELLS

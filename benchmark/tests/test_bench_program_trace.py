"""The program-span readings of a traced run (``harness/program_trace.py``)
on synthetic traces with known kernels, host ranges and spans: the gap
labels, the idle seconds by label, each idle share's reader and the
allocator's counters per round."""

import json

import pytest

from benchmark.harness import program_trace
from benchmark.harness.spec import ROOT, reader

MS = 1e-3


def _span(a_ms, b_ms, name, **args):
    return (a_ms * MS, b_ms * MS, name, {"step": 0, "fenced": False, **args})


def _trace():
    """A 100 ms window: kernels on [0, 40) and [60, 100) ms, so the
    device idles on [40, 60); inside it the host enqueues (40-45), a
    collection runs inside round.grads (45-52), the round source runs
    with no program span (52-55), and the loss bookkeeping (55-60)."""
    alloc = {"num_alloc_retries": 1, "num_device_alloc": 3,
             "num_device_free": 2, "num_sync_all_streams": 0}
    return {
        "window": (0.0, 100 * MS),
        "kernels": [(0.0, 20 * MS), (15 * MS, 40 * MS), (60 * MS, 100 * MS)],
        "ranges": [(0.0, 55 * MS, "dispatch"), (55 * MS, 60 * MS, "drain"),
                   (60 * MS, 100 * MS, "dispatch")],
        "spans": [
            _span(0, 52, "round_dispatch", trace_id="r0", rounds=2, **alloc),
            _span(38, 52, "round.grads", trace_id="r0",
                  parent="round_dispatch"),
            _span(45, 52, "gc", generation=1, collected=10,
                  uncollectable=0),
            _span(60, 100, "round_dispatch", trace_id="r1", rounds=2,
                  **alloc),
        ],
        "rounds": 4,
        "clock": {"marker_minus_trace_start_us": 12.0, "used": "trace_start"},
    }


def test_idle_seconds_by_label_and_shares():
    s = program_trace.summarize(_trace())
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.08)
    assert s["idle_share"] == pytest.approx(20.0)
    want = {"dispatch/round.grads": 5 * MS, "dispatch/gc": 7 * MS,
            "dispatch": 3 * MS, "drain": 5 * MS}
    assert s["idle_by_label"].keys() == want.keys()
    for k, v in want.items():
        assert s["idle_by_label"][k] == pytest.approx(v), k
    # the labels' idle adds up to the window's
    assert 100 * sum(s["idle_by_label"].values()) / s["window_s"] == \
        pytest.approx(s["idle_share"])
    assert s["shares"] == pytest.approx(
        {"enqueue": 5.0, "gc": 7.0, "stage": 0.0, "untraced": 3.0})
    # frees 2 + retries 1 a dispatch span, two spans of two rounds each
    assert s["alloc_frees_per_round"] == pytest.approx(1.5)
    assert s["alloc"]["num_device_alloc"] == 6 and s["alloc"]["rounds"] == 4


def test_a_gap_takes_the_label_that_holds_most_of_it():
    s = program_trace.summarize(_trace())
    (label, length), = s["idle_gaps"]
    assert label == "dispatch/gc" and length == pytest.approx(20 * MS)


def test_scan_stage_and_edges_of_the_window():
    """A scan engine's staging, idle before the first kernel and after
    the last; kernels outside the window are clipped off."""
    tr = {
        "window": (0.0, 50 * MS),
        "kernels": [(-5 * MS, 10 * MS), (20 * MS, 45 * MS),
                    (48 * MS, 70 * MS)],
        "ranges": [(0.0, 20 * MS, "epoch_staging"),
                   (20 * MS, 50 * MS, "dispatch")],
        "spans": [_span(12, 18, "scan_stage"),
                  _span(20, 44, "round_dispatch", trace_id="r4")],
        "rounds": 4,
        "clock": {"marker_minus_trace_start_us": None,
                  "used": "trace_start"},
    }
    s = program_trace.summarize(tr)
    assert s["busy_s"] == pytest.approx(37 * MS)
    assert s["idle_by_label"] == pytest.approx(
        {"epoch_staging": 4 * MS, "epoch_staging/scan_stage": 6 * MS,
         "dispatch": 3 * MS})
    assert s["shares"]["stage"] == pytest.approx(12.0)
    assert s["shares"]["untraced"] == pytest.approx(14.0)
    assert s["alloc_frees_per_round"] is None and s["alloc"] is None
    assert [g[0] for g in s["idle_gaps"]] == [
        "epoch_staging/scan_stage", "dispatch"]


class _Ctx:
    profile = None


@pytest.mark.parametrize("metric,key", [
    ("idle_enqueue_share.per_round", ("shares", "enqueue")),
    ("idle_gc_share", ("shares", "gc")),
    ("idle_gc_share.per_round", ("shares", "gc")),
    ("idle_stage_share", ("shares", "stage")),
    ("idle_untraced_share", ("shares", "untraced")),
    ("idle_untraced_share.per_round", ("shares", "untraced")),
    ("alloc_frees_per_round", ("alloc_frees_per_round",)),
    ("alloc_frees_per_round.per_round", ("alloc_frees_per_round",)),
])
def test_each_reader_reads_its_number(metric, key):
    ctx = _Ctx()
    ctx.program_trace = program_trace.summarize(_trace())
    want = ctx.program_trace
    for k in key:
        want = want[k]
    assert reader(metric).read(ctx) == pytest.approx(want)
    # an untraced run (or one on the CPU) reads nothing and raises nothing
    assert reader(metric).read(_Ctx()) is None


def test_the_new_metrics_name_the_cells_they_read():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    by = {m["name"]: m for m in spec["per_layer"]}
    gpt2 = ["gpt2.sketch", "gpt2.uncompressed"]
    scan = ["resnet9.sketch_scan4", "resnet9.uncompressed_scan4"]
    for name, cells in [("idle_enqueue_share.per_round", gpt2),
                        ("idle_gc_share", scan),
                        ("idle_gc_share.per_round", gpt2),
                        ("idle_stage_share", scan),
                        ("idle_untraced_share", scan),
                        ("idle_untraced_share.per_round", gpt2),
                        ("alloc_frees_per_round", scan),
                        ("alloc_frees_per_round.per_round", gpt2)]:
        m = by[name]
        assert m["workloads"] == cells and m["source"] == "program_span"
        assert m["moves"] == ("round_ms.per_round" if cells == gpt2
                              else "round_ms")

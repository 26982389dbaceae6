"""The span recorder's detail level (``telemetry/spans.py``,
``PhaseSpans(detail=True)``) on the CPU, at a tiny MLP's size: the
round's phase spans nested in ``round_dispatch``, the collector's spans,
the allocator's counters on a dispatch span, the shared clock with
``torch.profiler``, and that neither the default recorder nor no
recorder runs any of it. The default recorder's dump, stages and
``trace/*`` scalars are held to the reference's in
``tests/test_torch_trace.py``."""

import gc
import time
import warnings

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.interop import STATE_LEAVES
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.pipeline import ScanRounds
from commefficient_tpu_torch.telemetry import spans as spans_mod
from commefficient_tpu_torch.telemetry.spans import (
    ALLOC_COUNTERS,
    ROUND_PHASES,
    PhaseSpans,
)
from commefficient_tpu_torch.train.runner import round_source
from commefficient_tpu_torch.utils.config import Config

SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=40, num_rows=3, num_cols=256)


def _mlp(params, x):
    p = params["params"]
    h = torch.relu(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
    return h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]


def _build(**kw):
    """A session of 8 workers over 12 clients, the training set attached
    on the device (the benchmark's index path), and its sampler."""
    rng = np.random.default_rng(0)

    def dense(i, o):
        return {"kernel": (0.3 * rng.normal(size=(i, o))).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    params = {"params": {"Dense_0": dense(8, 16), "Dense_1": dense(16, 4)}}
    x = rng.normal(size=(600, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=600).astype(np.int32)
    cfg = Config(**{"num_clients": 12, "num_workers": 8, "num_devices": 1,
                    "local_batch_size": 4, "weight_decay": 0.0, "seed": 5,
                    **SKETCH, **kw}, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, params, classification_loss(_mlp))
    ds = FedDataset({"x": x, "y": y}, 12, iid=True, seed=0)
    sampler = FedSampler(ds, num_workers=8, local_batch_size=4, seed=1)
    assert sess.maybe_attach_data(ds, sampler)
    return sess, sampler


def _rounds(sess, sampler, n, attach=None, at=0):
    """``n`` rounds through the runner's round source; ``attach`` goes
    on ``sess.spans`` before round ``at`` and comes off after the last."""
    src = round_source(sess.cfg, sess, sampler, lambda s: 0.1, 0, n)
    try:
        for i in range(n):
            if i == at and attach is not None:
                sess.spans = attach
            next(src)
    finally:
        src.close()
        sess.spans = None


def _named(rec, name):
    return [e for e in rec.events if e["name"] == name]


def test_detailed_round_records_its_phases_inside_round_dispatch():
    """Attached mid-epoch: every round after records the four phases,
    in order, inside its own round_dispatch, with its trace id and the
    parent, and the depth-0 source's data wait as data_load."""
    sess, sampler = _build()
    rec = PhaseSpans("", num_steps=0, detail=True)
    _rounds(sess, sampler, 4, attach=rec, at=1)
    rec.close()
    dispatch = _named(rec, "round_dispatch")
    assert [e["args"]["trace_id"] for e in dispatch] == ["r1", "r2", "r3"]
    assert len(_named(rec, "data_load")) == 3
    assert not any(e["args"]["fenced"] for e in rec.events)
    for d in dispatch:
        tid = d["args"]["trace_id"]
        phases = [e for e in rec.events if e["name"] in ROUND_PHASES
                  and e["args"]["trace_id"] == tid]
        assert [e["name"] for e in phases] == list(ROUND_PHASES)
        end = d["ts"]
        for e in phases:
            assert e["args"]["parent"] == "round_dispatch"
            assert e["ts"] >= end and e["tid"] == d["tid"]
            end = e["ts"] + e["dur"]
        assert end <= d["ts"] + d["dur"]
    # in memory: nothing is written without a logdir
    assert rec.dump() is None


def test_a_callers_mark_still_fires_all_five_with_a_detailed_recorder():
    """A wrapper that passes its own mark (the benchmark's phase timer)
    keeps every mark, and the phase spans are recorded beside them."""
    sess, sampler = _build()
    inner, fired = sess.round_fn, []

    def marked(*a, **kw):
        return inner(*a, mark=fired.append, **kw)

    sess.round_fn = marked
    rec = PhaseSpans("", num_steps=0, detail=True)
    _rounds(sess, sampler, 2, attach=rec)
    rec.close()
    assert fired == [0, 1, 2, 3, 4] * 2
    assert [e["name"] for e in rec.events if e["name"] in ROUND_PHASES] \
        == list(ROUND_PHASES) * 2
    assert sess._round_closure.phase_mark is None


def test_traced_and_untraced_rounds_leave_equal_state():
    plain, s_plain = _build()
    traced, s_traced = _build()
    _rounds(plain, s_plain, 3)
    rec = PhaseSpans("", num_steps=0, detail=True)
    _rounds(traced, s_traced, 3, attach=rec)
    rec.close()
    assert _named(rec, "round.grads")
    for leaf in STATE_LEAVES:
        a, b = getattr(plain.state, leaf), getattr(traced.state, leaf)
        if torch.is_tensor(a):
            assert torch.equal(a, b), leaf
        else:
            assert a == b, leaf


def test_collections_are_gc_spans_until_close():
    rec = PhaseSpans("", num_steps=0, detail=True)
    assert rec._gc_hook in gc.callbacks
    rec.step(7)
    gc.collect(1)
    rec.flush()
    (ev,) = [e for e in _named(rec, "gc") if e["args"]["generation"] == 1]
    assert ev["args"]["step"] == 7 and ev["dur"] >= 0
    assert {"collected", "uncollectable"} <= set(ev["args"])
    rec.close()
    assert rec._gc_hook is None
    n = len(rec.events)
    gc.collect()
    rec.flush()
    assert len(rec.events) == n


def test_a_collection_inside_a_recording_is_kept():
    """A collection that starts while the recorder holds its lock (inside
    ``_record``) waits for the next recording, with its own times."""
    rec = PhaseSpans("", num_steps=0, detail=True)
    real = rec._append

    def append(ev):
        gc.collect(0)
        real(ev)

    rec._append = append
    rec.span_at("x", 1.0, 2.0)
    rec._append = real
    rec.span_at("y", 3.0, 4.0)
    rec.close()
    names = [e["name"] for e in rec.events]
    assert names[:2] == ["x", "gc"] and names[-1] == "y"


def test_allocator_counters_ride_a_detailed_dispatch_span(monkeypatch):
    reads = iter([{k: 10 for k in ALLOC_COUNTERS},
                  {**{k: 10 for k in ALLOC_COUNTERS},
                   "num_device_free": 13, "num_alloc_retries": 11}])
    monkeypatch.setattr(spans_mod, "_alloc_counts", lambda dev: next(reads))
    rec = PhaseSpans("", num_steps=0, detail=True)
    with rec.span("round_dispatch", allocator=torch.device("cuda"),
                  rounds=4):
        pass
    with rec.span("round_dispatch", allocator=torch.device("cpu")):
        pass
    rec.close()
    first, second = rec.events
    assert {k: first["args"][k] for k in ALLOC_COUNTERS} == {
        "num_alloc_retries": 1, "num_device_alloc": 0,
        "num_device_free": 3, "num_sync_all_streams": 0}
    assert first["args"]["rounds"] == 4
    assert "rounds" not in second["args"]


@pytest.mark.parametrize("recorder", ["none", "default"])
def test_no_detail_without_a_detailed_recorder(monkeypatch, tmp_path,
                                               recorder):
    """No recorder, or the train loop's: no phase span, no collector
    hook, no allocator read, and the round function gets no phase
    callback."""
    def refuse(dev):
        raise AssertionError("allocator read without detail")

    monkeypatch.setattr(spans_mod, "_alloc_counts", refuse)
    sess, sampler = _build()
    hooks = list(gc.callbacks)
    rec = PhaseSpans(str(tmp_path)) if recorder == "default" else None
    inner, phase_marks = sess.round_fn, []

    def spy(*a, **kw):
        phase_marks.append(sess._round_closure.phase_mark)
        return inner(*a, **kw)

    sess.round_fn = spy
    _rounds(sess, sampler, 2, attach=rec)
    assert gc.callbacks == hooks
    assert phase_marks == [None, None]
    if rec is not None:
        with rec.span("round_dispatch", allocator=torch.device("cuda")):
            pass
        names = {e["name"] for e in rec.events}
        assert names == {"data_load", "device_put", "fedsim_env",
                         "round_dispatch"}
        assert all(set(e["args"]) <= {"step", "fenced", "trace_id"}
                   for e in rec.events)
        assert rec.close() is not None


def test_scan_engine_records_on_a_recorder_attached_after_it_was_built():
    """The round source builds its scan engine before the benchmark
    attaches a recorder: the engine records on the session's."""
    sess, sampler = _build(topk_method="threshold", scan_rounds=3)
    eng = ScanRounds(sess.cfg, sess, sampler, lambda s: 0.1, 6,
                     steps_per_epoch=6).start(0)
    rec = PhaseSpans("", num_steps=0, detail=True)
    sess.spans = rec
    try:
        got = list(eng.epoch_rounds(0, 0, 6))
    finally:
        sess.spans = None
        eng.close()
        rec.close()
    assert len(got) == 6
    assert [e["args"]["trace_id"] for e in _named(rec, "round_dispatch")] \
        == ["r0", "r3"]
    assert len(_named(rec, "scan_stage")) == 1


def test_span_maps_onto_the_profiler_trace_within_a_millisecond():
    """The recorder's wall-clock pair and the profiler's trace start put
    a span where the profiler puts a record_function of the same name."""
    rec = PhaseSpans("", num_steps=0, detail=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("warm"):
            pass
        with rec.span("probe"):
            with torch.profiler.record_function("probe"):
                time.sleep(0.02)
    rec.close()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "probe"]
    (sp,) = _named(rec, "probe")
    a_us = (rec.unix_ns(sp["ts"]) - start_ns) / 1e3
    b_us = (rec.unix_ns(sp["ts"] + sp["dur"]) - start_ns) / 1e3
    assert abs(a_us - ev.time_range.start) < 1000
    assert abs(b_us - ev.time_range.end) < 1000

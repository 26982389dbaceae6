"""The port's host spans, critical path, run report and round audit
(``commefficient_tpu_torch/telemetry/spans.py``, ``trace.py``,
``round_audit.py``, the worker group's ``CollectiveCounter``) against the
reference, on the CPU, at TinyMLP size.

* (a) ``PhaseSpans`` fed the same ``span_at`` intervals, steps, lanes,
  collective tags and trace ids as the reference's writes the same dump
  (the ``ts`` origin set equal), with the same exposure, also past the
  ring's bound; the port's per-step index equals the ring's buckets;
* (b) ``CriticalPath``, ``trace_round_scalars`` and ``build_run_report``
  equal the reference's on one port run's spans dump and
  ``metrics.jsonl`` (all but ``generated_by`` and ``run_dir``);
* (c) each round's step-indexed ``trace/*`` scalars and
  ``xla/exposed_collective_ms`` equal the reference's whole-ring ones,
  round by round over 12 rounds, at depth 0 and 2;
* (d) ``cv_train.main --device cpu --telemetry_level 1`` at depth 0 and 2
  writes a run dir the reference's ``scripts/check_telemetry_schema.py``
  accepts (spans, run and perf reports included), one ``round_dispatch``
  a round, the prefetch spans on the labelled lane, and the
  ``telemetry.trace`` command's report;
* (e) every state leaf bit-equal with the audit, the report and an
  overlapping ``--profile_rounds`` window on and off;
* (f) ``perf_report.json``'s FLOPs equal TinyMLP's GEMM FLOPs by hand;
* (g) two gloo ranks of sketch: the table's all-reduce counted, the
  ledger cross-check within tolerance, the exposure the spans' own;
* (h) ``Config``'s lifted fields, ``max_retraces`` still refused;
* the profiler window's clamp and resume, ``parse_profile_rounds`` and
  the anomaly flags against the reference's.
"""

import importlib.util
import json
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from commefficient_tpu.telemetry import spans as ref_spans
from commefficient_tpu.telemetry import trace as ref_trace
from commefficient_tpu.telemetry.xla_audit import (
    exposed_collective_ms as ref_exposed,
)
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.interop import STATE_LEAVES
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.telemetry import spans as port_spans
from commefficient_tpu_torch.telemetry import trace as port_trace
from commefficient_tpu_torch.train import cv_train
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.config import Config, parse_args
from commefficient_tpu_torch.utils.logging import MetricsWriter
from test_round import BASE, D_IN, N_CLASSES
from test_torch_gloo_worker import spawn
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_round import _write_cifar_pickles
from test_torch_sharded_decode import LR, rounds  # noqa: F401
from test_torch_sparse_aggregate import job_arrays

ROOT = Path(__file__).resolve().parents[1]
ONE = {**BASE, "num_devices": 1}
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=40, num_rows=3, num_cols=256)
HIDDEN = 16  # TinyMLP's hidden width (tests/test_round.py)


def _checker():
    """The reference's schema checker, loaded by path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", ROOT / "scripts" / "check_telemetry_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Hooks(WorkloadHooks):
    def new_accumulator(self):
        return {}

    def accumulate(self, acc, loss, metrics):
        pass

    def evaluate(self):
        return {"loss": 0.0}

    def write_val(self, writer, val, step):
        writer.scalar("val/loss", val["loss"], step)

    def epoch_row(self, **kw):
        return {"epoch": kw["epoch"]}


def _loop_run(rounds_, tmp_path, kw=None, name="run", rounds_n=12,
              capture=False):
    """``run_train_loop`` of sketch at level 1 with a ``MetricsWriter``:
    ``(run dir, session, captured)``, ``captured`` each round's metrics
    as the session returned them, with the reference's whole-ring
    ``trace/*`` and exposure taken at that moment (when ``capture``)."""
    ds, params, _, _ = rounds_
    cfg = Config(**{**ONE, **SKETCH, "telemetry_level": 1, "num_epochs": 2,
                    "max_rounds": rounds_n, **(kw or {})}, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, to_numpy_tree(params),
                                classification_loss(torch_tinymlp))
    sampler = FedSampler(FedDataset(ds.data, BASE["num_clients"], iid=True,
                                    seed=0), num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size, seed=1)
    captured = []
    if capture:
        round_fn = sess._round

        def traced(*a, **k):
            m = round_fn(*a, **k)
            ref = ref_trace.trace_round_scalars(sess.spans,
                                                sess.state.step - 2)
            ref["xla/exposed_collective_ms"] = ref_exposed(sess.spans,
                                                           sess.last_audit)
            # the reference's sentinel count at level >= 1: the per-round
            # path captures nothing
            ref["xla/retraces"] = 0.0
            captured.append(({k: v for k, v in m.items()
                              if k.startswith(("trace/", "xla/"))}, ref))
            return m

        sess._round = traced
    run_dir = tmp_path / name
    writer = MetricsWriter(str(run_dir), cfg=cfg)
    try:
        run_train_loop(cfg, sess, sampler, _Hooks(), writer=writer,
                       generated_by="tests")
    finally:
        writer.close()
    return run_dir, sess, captured


def _dump(run_dir):
    (path,) = Path(run_dir).glob("spans_*.json")
    return json.loads(path.read_text())


# -- (a) PhaseSpans against the reference's ---------------------------------


def _feed(recorders, case):
    """The same recordings into every recorder: steps on the main lane, a
    worker lane's spans, collective tags, trace ids and parents."""
    t = 1000.0
    if case == "evicted":
        n = port_spans.MAX_EVENTS + 700
        for i in range(n):
            step = i // 5
            for sp in recorders:
                sp.step(step)
                sp.span_at("round_dispatch" if i % 5 == 2 else "data_load",
                           t + i * 1e-3, t + i * 1e-3 + 7e-4,
                           collective=i % 5 == 2,
                           trace_id=f"r{step}")
        return

    def worker():
        for sp in recorders:
            sp.register_lane("round-prefetch")
        for s in range(6):
            for sp in recorders:
                sp.span_at("prefetch_realize", t + 0.01 * s,
                           t + 0.01 * s + 0.004, step=s, trace_id=f"r{s}")
                sp.span_at("prefetch_stage", t + 0.01 * s + 0.004,
                           t + 0.01 * s + 0.006, step=s, trace_id=f"r{s}")

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    for s in range(6):
        a = t + 0.05 + 0.02 * s
        for sp in recorders:
            sp.span_at("data_load", a - 0.002, a)
            sp.step(s)
            sp.span_at("device_put", a, a + 0.001, trace_id=f"r{s}")
            sp.span_at("fedsim_env", a + 0.001, a + 0.0015,
                       trace_id=f"r{s}")
            # a dispatch overlapped in part by a worker-lane span
            over = 0.004 if case == "overlap" else 0.0
            sp.span_at("round_dispatch", a + 0.0015 - over, a + 0.012,
                       collective=True, trace_id=f"r{s}")
            if s % 3 == 2:
                sp.span_at("metric_drain", a + 0.012, a + 0.016,
                           trace_id=f"r{s}")
                sp.span_at("checkpoint", a + 0.016, a + 0.017)
            sp.span_at("async_cohort", a, a + 0.002, trace_id=f"c{s}",
                       parent=f"r{s}")


@pytest.mark.parametrize("case", ["rounds", "overlap", "evicted"])
def test_phase_spans_dump_matches_reference(tmp_path, case):
    ref = ref_spans.PhaseSpans(str(tmp_path / "ref"))
    port = port_spans.PhaseSpans(str(tmp_path / "port"))
    port._t0 = ref._t0 = 900.0  # the ts origin
    _feed([ref, port], case)
    assert port.collective_exposure_ms() == ref.collective_exposure_ms()
    want = json.loads(Path(ref.close()).read_text())
    got = json.loads(Path(port.close()).read_text())
    assert got == want
    assert port.collective_exposure_ms() > 0
    # the step index holds what the ring's buckets hold, in ring order
    buckets = ref_trace.CriticalPath(list(ref.events))._by_step
    for step in {e["args"]["step"] for e in port.events}:
        assert port.events_of(step) == buckets.get(step, []), step
    if case == "evicted":
        assert len(port.events) == port_spans.MAX_EVENTS
        assert port.events_of(0) == []  # evicted with its events


def test_span_context_fences_only_in_its_window(tmp_path):
    """``span`` records what the reference's does (names, steps, the
    fenced flag inside the window only, the collective tag); a fence on a
    CPU tensor returns at once."""
    ref = ref_spans.PhaseSpans(str(tmp_path / "ref"), start_step=2,
                               num_steps=2)
    port = port_spans.PhaseSpans(str(tmp_path / "port"), start_step=2,
                                 num_steps=2)
    import jax.numpy as jnp

    for s in range(6):
        for sp, x in ((ref, jnp.ones(())), (port, torch.ones(()))):
            sp.step(s)
            with sp.span("round_dispatch", collective=True,
                         trace_id=f"r{s}") as h:
                h.fence(x)
            for _ in sp.wrap_iter(iter([1])):
                pass
    strip = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
             for e in port.events]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                     for e in ref.events]
    assert [e["args"]["fenced"] for e in port.events
            if e["name"] == "round_dispatch"] == [False, False, True, True,
                                                  False, False]
    idle = port_spans.PhaseSpans("")
    with idle.span("x") as h:
        assert h is None
    assert idle.close() is None and not idle.events


# -- (b), (c) critical path, scalars, run report -----------------------------


@pytest.mark.parametrize("depth", [0, 2])
def test_critical_path_scalars_and_run_report_match_reference(
        rounds, tmp_path, depth):
    run_dir, _, captured = _loop_run(rounds, tmp_path,
                                     {"pipeline_depth": depth},
                                     capture=True)
    events = _dump(run_dir)["traceEvents"]
    ref_cp, port_cp = ref_trace.CriticalPath(events), \
        port_trace.CriticalPath(events)
    # depth 0's first data wait is on the pre-round clock, step -1
    assert port_cp.steps() == ref_cp.steps() == list(
        range(-1 if depth == 0 else 0, 12))
    for s in ref_cp.steps():
        assert port_cp.round_breakdown(s) == ref_cp.round_breakdown(s)

    class Ring:  # a spans stand-in over the dump: the ring, the index
        def __init__(self, evs):
            self.events = evs

        def events_of(self, step):
            return [e for e in self.events if e.get("ph") == "X"
                    and e["args"]["step"] == step]

    ring = Ring(events)
    for s in range(-3, 14):
        assert port_trace.trace_round_scalars(ring, s) == \
            ref_trace.trace_round_scalars(ring, s)
    want = ref_trace.build_run_report(str(run_dir), generated_by="x")
    got = port_trace.build_run_report(str(run_dir), generated_by="y")
    written = json.loads((run_dir / "run_report.json").read_text())
    for rep in (want, got, written):
        rep.pop("generated_by")
        rep.pop("run_dir")
    assert got == want
    assert written == json.loads(json.dumps(want))
    assert want["rounds_analyzed"] == 12 and want["sources"]["perf_report"]
    # (c) each round's step-indexed scalars are the whole ring's
    assert len(captured) == 12
    for r, (got_r, ref_r) in enumerate(captured):
        assert got_r == ref_r, r
    assert any(got_r["trace/dispatch_exclusive_ms"] > 0
               for got_r, _ in captured[2:])


# -- (d) the run dir through the reference's checker -------------------------


@pytest.mark.parametrize("depth", ["0", "2"])
def test_cv_train_run_dir_passes_the_reference_checker(tmp_path, depth,
                                                       capsys):
    _write_cifar_pickles(str(tmp_path))
    out = cv_train.main(
        ["--mode", "sketch", "--k", "20", "--num_rows", "3", "--num_cols",
         "200", "--error_type", "virtual", "--virtual_momentum", "0.9",
         "--num_clients", "4", "--num_workers", "2", "--local_batch_size",
         "4", "--num_epochs", "2", "--compute_dtype", "float32",
         "--telemetry_level", "1", "--pipeline_depth", depth,
         "--dataset_dir", str(tmp_path), "--logdir", str(tmp_path / "runs"),
         "--device", "cpu"], eval_batch_size=8, model_kw={"width": 4})
    run_dir = Path(out["logdir"])
    checked = _checker().validate_run_dir(run_dir)
    n = len(out["history"])
    for name in ("metrics.jsonl", "comm_ledger.json", "perf_report.json",
                 "spans_0.json", "run_report.json"):
        assert str(run_dir / name) in checked, name
    header = json.loads((run_dir / "metrics.jsonl").open().readline())
    assert header["artifacts"] == {
        "perf_report": str(run_dir / "perf_report.json"),
        "run_report": str(run_dir / "run_report.json")}
    dump = _dump(run_dir)
    disp = [e for e in dump["traceEvents"] if e["name"] == "round_dispatch"]
    assert [e["args"]["step"] for e in disp] == list(range(n))
    assert all("collective" not in e["args"] for e in disp)  # one device
    lanes = {e["tid"]: e["args"]["name"] for e in dump["traceEvents"]
             if e["ph"] == "M"}
    pre = [e for e in dump["traceEvents"] if e["name"].startswith("prefetch")]
    if depth == "2":
        assert lanes == {1: "round-prefetch"} and len(pre) == 2 * n
        assert {e["tid"] for e in pre} == {1}
    else:
        assert not lanes and not pre
    report = json.loads((run_dir / "run_report.json").read_text())
    assert report["rounds_analyzed"] == n
    assert abs(sum(b["fraction"] for b in report["stages"].values())
               - 1) < 1e-9
    for r in report["rounds"]:
        assert abs(sum(r["stages_ms"].values()) - r["wall_ms"]) < 1e-6
    perf = json.loads((run_dir / "perf_report.json").read_text())
    assert perf["cost"]["flops"] > 0 and perf["collectives"]["ops"] == {}
    assert perf["collectives"]["total_bytes"] == 0
    assert perf["memory"]["peak_hbm_bytes"] is None  # no card
    scalars = [json.loads(line) for line in
               (run_dir / "metrics.jsonl").read_text().splitlines()[1:]]
    exposed = [r["value"] for r in scalars
               if r.get("name") == "xla/exposed_collective_ms"]
    assert exposed == [0.0] * n
    names = {r.get("name") for r in scalars}
    assert {"trace/critical_stage", "trace/idle_exclusive_ms",
            "xla/audited_flops"} <= names
    assert ("pipeline/host_stall_ms" in names) == (depth == "2")
    # the run-report command on the same dir
    capsys.readouterr()
    assert port_trace.main([str(run_dir), "--out", "again.json"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"kind": "analyze_run", "run_dirs": 1, "reports": 1,
                    "failures": []}
    again = json.loads((run_dir / "again.json").read_text())
    assert {k: v for k, v in again.items() if k != "generated_by"} == \
        {k: v for k, v in report.items() if k != "generated_by"}
    assert port_trace.main([]) == 2
    assert port_trace.main([str(tmp_path / "nothing")]) == 1


# -- (e) values with the audit, the report and the window on and off ---------


@pytest.mark.parametrize("depth", [0, 2])
def test_leaves_bit_equal_with_audit_report_and_window_on_and_off(
        rounds, tmp_path, depth, capsys):
    on, sess_on, _ = _loop_run(rounds, tmp_path, {
        "pipeline_depth": depth, "profile_rounds": "4-5",
        "profile_dir": str(tmp_path / "prof")}, name="on", rounds_n=9)
    off, sess_off, _ = _loop_run(rounds, tmp_path, {
        "pipeline_depth": depth, "perf_audit": False, "run_report": False},
        name="off", rounds_n=9)
    printed = capsys.readouterr().out
    # the window starts at 4; the StepProfiler's (5-7) start is refused
    assert "[profile_rounds] capturing rounds [4, 6)" in printed
    assert "[profile_dir] start_trace unavailable" in printed
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1
    for leaf in STATE_LEAVES:
        a, b = getattr(sess_on.state, leaf), getattr(sess_off.state, leaf)
        if torch.is_tensor(a):
            assert torch.equal(a, b), leaf
        else:
            assert a == b, leaf
    assert (on / "perf_report.json").exists()
    assert (on / "run_report.json").exists()
    assert not (off / "perf_report.json").exists()
    assert not (off / "run_report.json").exists()
    assert list(off.glob("spans_*.json"))  # level 1 always has spans
    _checker().validate_run_dir(off)


# -- (f) the FLOP count ------------------------------------------------------


def test_perf_report_flops_equal_the_hand_count(rounds, tmp_path):
    """Round 0 over all W clients of B samples: TinyMLP's two GEMMs
    forward, both weight gradients, and the hidden layer's input
    gradient (the first layer's input needs none)."""
    run_dir, _, _ = _loop_run(rounds, tmp_path, rounds_n=2)
    perf = json.loads((run_dir / "perf_report.json").read_text())
    n = BASE["num_workers"] * BASE["local_batch_size"]
    gemm = 2 * n * (D_IN * HIDDEN + HIDDEN * N_CLASSES)
    want = 2 * gemm + 2 * n * HIDDEN * N_CLASSES
    assert perf["cost"]["flops"] == want
    assert perf["cost"]["bytes_accessed"] is None
    assert "FlopCounterMode" in perf["cost"]["unavailable_reason"]
    assert perf["audited_step"] == 0 and perf["engine"] == "replicated"
    assert perf["predicted"]["peak_flops"] is None


def test_flop_counter_counts_a_grouped_weight_gradient_once():
    """Per-client weights under ``vmap`` make grouped convolutions; the
    audit's counter charges each weight gradient the forward's products
    (torch's own formula charges it ``groups`` times), the input gradient
    as torch does, and a dense convolution as torch does."""
    from torch.utils.flop_counter import FlopCounterMode

    from commefficient_tpu_torch.telemetry.round_audit import flop_counter

    W, B, cin, cout, h = 3, 2, 4, 6, 5
    fwd = W * B * h * h * 9 * cin * cout * 2
    w = torch.randn(W, cout, cin, 3, 3)
    x = torch.randn(W, B, cin, h, h)

    def loss(wc, xc):
        return torch.nn.functional.conv2d(xc, wc, padding=1).square().sum()

    for argnums, want in ((0, 2 * fwd), ((0, 1), 3 * fwd)):
        step = torch.func.vmap(torch.func.grad(loss, argnums=argnums))
        with flop_counter() as fc:
            step(w, x)
        with FlopCounterMode(display=False) as torch_fc:
            step(w, x)
        assert fc.get_total_flops() == want, argnums
        assert torch_fc.get_total_flops() == want + (W - 1) * fwd
    xt = torch.randn(B, cin, h, h, requires_grad=True)
    wt = torch.randn(cin, cout, 3, 3, requires_grad=True)
    counts = []
    for mode in (flop_counter(), FlopCounterMode(display=False)):
        with mode:
            torch.nn.functional.conv_transpose2d(
                xt, wt, padding=1).sum().backward()
        counts.append(mode.get_total_flops())
    assert counts[0] == counts[1] > 0


def test_resnet9_round_flops_equal_one_dense_backward(tmp_path):
    """``cv_train``'s round 0 with per-client steps (``--fuse_clients
    false``: grouped convolutions under ``vmap``) counts what one dense
    forward and backward of the same W*B images counts."""
    from commefficient_tpu_torch.models.resnet9 import (
        init_resnet9,
        resnet9_apply,
    )
    from commefficient_tpu_torch.telemetry.round_audit import flop_counter

    _write_cifar_pickles(str(tmp_path))
    out = cv_train.main(
        ["--mode", "uncompressed", "--num_clients", "4", "--num_workers",
         "2", "--local_batch_size", "4", "--num_epochs", "1",
         "--max_rounds", "1", "--fuse_clients", "false",
         "--compute_dtype", "float32", "--telemetry_level", "1",
         "--dataset_dir", str(tmp_path), "--logdir", str(tmp_path / "runs"),
         "--device", "cpu"], eval_batch_size=8, model_kw={"width": 4})
    perf = json.loads((Path(out["logdir"]) / "perf_report.json").read_text())
    params = init_resnet9(42, width=4)
    leaves = [t.requires_grad_() for t in
              [params["params"]["Dense_0"]["kernel"]]
              + [v["kernel"] for v in _conv_kernels(params["params"])]]
    with flop_counter() as fc:
        logits = resnet9_apply(params, torch.randn(8, 32, 32, 3),
                               dtype=torch.float32)
        torch.autograd.grad(logits.sum(), leaves)
    assert perf["cost"]["flops"] == fc.get_total_flops() > 0


def _conv_kernels(tree):
    for v in tree.values():
        if isinstance(v, dict):
            if "kernel" in v and v["kernel"].dim() == 4:
                yield v
            else:
                yield from _conv_kernels(v)


# -- (g) two gloo ranks -----------------------------------------------------


def test_two_gloo_ranks_count_the_table_all_reduce(rounds, tmp_path_factory):
    ds = rounds[0]
    two = {**BASE, "num_devices": 2, **SKETCH, "telemetry_level": 1,
           "num_epochs": 1, "max_rounds": 8}
    arrays = {**job_arrays(rounds), "trace/x": ds.data["x"],
              "trace/y": ds.data["y"]}
    ranks = spawn({"lr": LR, "trace": {"sketch": two}}, arrays, 2,
                  tmp_path_factory)
    np.testing.assert_array_equal(ranks[0]["trace:sketch/params"],
                                  ranks[1]["trace:sketch/params"])
    assert "trace:sketch/run_dir" not in ranks[1]  # rank 0 writes alone
    run_dir = Path(str(ranks[0]["trace:sketch/run_dir"]))
    _checker().validate_run_dir(run_dir)
    perf = json.loads((run_dir / "perf_report.json").read_text())
    coll = perf["collectives"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(Config(**{**two, "num_devices": 1},
                                       device="cpu"),
                                to_numpy_tree(rounds[1]),
                                classification_loss(torch_tinymlp))
    r, c = sess.spec.table_shape
    table = 4 * r * c
    ar = coll["ops"]["all-reduce"]
    assert coll["max_all_reduce_elems"] == r * c
    assert table <= ar["bytes"] <= table + 4096
    assert coll["ledger_up_bytes"] == sess.bytes_per_round()["upload_bytes"]
    assert coll["within_tolerance"] is True
    assert coll["tolerance_bytes"] == 4096 and perf["workers_mesh"] == 2
    exposed = ranks[0]["trace:sketch/exposed"]
    assert len(exposed) == 8 and (exposed > 0).all()
    assert np.all(np.diff(exposed) >= 0)  # a cumulative gauge
    dump = _dump(run_dir)
    assert exposed[-1] == dump["exposed_collective_ms"]
    assert all(e["args"].get("collective") for e in dump["traceEvents"]
               if e["name"] == "round_dispatch")


# -- (h) and the units -------------------------------------------------------


def test_config_lifts_the_reports_and_the_window_and_refuses_retraces():
    cfg = parse_args(["--perf_audit", "false", "--run_report", "false",
                      "--profile_rounds", "3-4"])
    assert (cfg.perf_audit, cfg.run_report, cfg.profile_rounds) == (
        False, False, "3-4")
    assert Config(max_retraces=2).max_retraces == 2  # the scan engine's
    with pytest.raises(ValueError, match="max_retraces must be >= 0"):
        Config(max_retraces=-1)
    for bad in ("3", "a-b", "4-3", "-1-2"):
        with pytest.raises(ValueError, match="profile_rounds") as port:
            Config(profile_rounds=bad)
        with pytest.raises(ValueError) as ref:
            ref_trace.parse_profile_rounds(bad)
        assert str(port.value) == str(ref.value)


def test_profiler_window_matches_reference(monkeypatch, tmp_path):
    """The same step sequences (a window, a resume past it, a resume into
    it, a clamped start) open and close the capture at the same steps as
    the reference's window, whose jax trace calls are recorded instead of
    run; each port window writes one Chrome trace."""
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda *_: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    fences = []
    for i, (spec, resume, steps) in enumerate([
            ("5-7", None, range(12)), ("0-1", None, range(6)),
            ("5-7", 6, range(6, 14)), ("5-7", 3, range(3, 12))]):
        ref = ref_trace.ProfilerWindow(spec, str(tmp_path / "ref"))
        port = port_trace.ProfilerWindow(
            spec, str(tmp_path / f"port{i}"),
            fence_fn=lambda: fences.append(1))
        if resume is not None:
            ref.resume_at(resume)
            port.resume_at(resume)
        for s in steps:
            ref.step(s)
            port.step(s)
            assert port.active == ref._active, (spec, resume, s)
        port.close()
        assert len(list((tmp_path / f"port{i}").glob(
            "*.pt.trace.json"))) == 1
    assert len(fences) == 8  # entry and exit of each window


def _series(kind):
    if kind == "stall":
        return {"pipeline/host_stall_ms": [1.0] * 9 + [40.0]}
    if kind == "staleness":
        return {"async/staleness_mean": [0.5] * 6 + [4.0] * 6}
    if kind == "cache":
        return {"clientstore/cache_hit_rate": [0.9] * 6 + [0.1] * 6}
    return {"pipeline/host_stall_ms": [1.0] * 12}


@pytest.mark.parametrize("kind", ["stall", "staleness", "cache", "quiet"])
def test_anomaly_flags_match_reference(kind):
    got = port_trace._detect_anomalies(_series(kind))
    assert got == ref_trace._detect_anomalies(_series(kind))
    assert bool(got) == (kind != "quiet")
    for q in (0.0, 0.5, 0.95, 1.0):
        xs = list(_series(kind).values())[0]
        assert port_trace._percentile(xs, q) == ref_trace._percentile(xs, q)

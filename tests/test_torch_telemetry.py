"""The port's round telemetry (``commefficient_tpu_torch/telemetry/``,
``utils/logging.py``, ``utils/profiling.py``) against the reference, on
the CPU, at TinyMLP size.

* diagnostic twins: four rounds of the six modes (sketch with f32 and
  with bf16 tables, true_topk, local_topk with local error, fedavg,
  powersgd, uncompressed) at levels 1 and 2, from the reference's initial
  state: every ``diag/*`` scalar of every round against the reference's
  ``build_round_fn``, norms at ``rtol 1e-5, atol 1e-6``, the fidelity
  scalars at ``rtol 1e-4, atol 1e-6``, ``diag/nonfinite`` exactly; the
  sharded decode's ``diagnostics_sparse`` at one device and on two gloo
  ranks, true_topk's sharded state and FSDP on two gloo ranks, against
  the reference's mesh;
* level 0: the round's metric keys are exactly those without telemetry,
  and the params after four rounds are bit-equal at levels 0, 1 and 2;
* the ledger's exactness (``cum_* == rounds * bytes_per_round`` for
  sketch, local_topk and powersgd; the masked live/avail invariant under
  bernoulli participation), and the run dirs (plain, fedsim-masked,
  divergence) accepted by the reference's
  ``scripts/check_telemetry_schema.py`` (loaded by path here only);
* divergence: ``cv_train.main --chaos nan_client@2 --telemetry_level 1``
  raises ``DivergenceError`` naming round 2, writes ``flight_2.json`` and
  the ledger;
* ``table_sqnorm_estimate`` and ``l2_estimate`` (K3's plain network here)
  against the reference at r = 3, 4, 5, a NaN row giving NaN;
* host units: ``pack_metric_dicts``, ``MetricsWriter``, the
  ``StepProfiler`` window against the reference's, ``FlightRecorder``,
  ``CommLedger`` snapshots.
"""

import importlib.util
import json
import math
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import commefficient_tpu.parallel.round as ref_round
from commefficient_tpu.ops import countsketch as ref_cs
from commefficient_tpu.ops import topk as ref_topk
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.interop import STATE_LEAVES, state_from_jax
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops import countsketch as port_cs
from commefficient_tpu_torch.ops import topk as port_topk
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.telemetry import (
    DivergenceError,
    FlightRecorder,
    CommLedger,
    jsonable_tree,
    run_artifacts,
)
from commefficient_tpu_torch.train import cv_train
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.config import Config
from commefficient_tpu_torch.utils.logging import (
    MetricsWriter,
    pack_metric_dicts,
)
from commefficient_tpu_torch.utils.profiling import StepProfiler
from test_round import BASE
from test_torch_gloo_worker import spawn
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_round import _write_cifar_pickles
from test_torch_sharded_decode import LR, _split, rounds  # noqa: F401
from test_torch_sparse_aggregate import (
    TWO_RANK_CASES,
    _without_vma_check,
    job_arrays,
)

ROOT = Path(__file__).resolve().parents[1]
ONE = {**BASE, "num_devices": 1}
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=40, num_rows=3, num_cols=256)
# mode case -> Config keywords over BASE at one device
TEL_MODES = {
    "sketch": SKETCH,
    "sketch_bf16_tables": {**SKETCH, "topk_method": "threshold",
                           "sketch_table_dtype": "bfloat16"},
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9, k=40),
    "local_topk_local_error": dict(mode="local_topk", error_type="local",
                                   local_momentum=0.9, k=30),
    "fedavg": dict(mode="fedavg", num_local_iters=2, local_lr=0.1),
    "powersgd": dict(mode="powersgd", error_type="virtual", powersgd_rank=2,
                     virtual_momentum=0.9),
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9),
}
FIDELITY = ("diag/sketch_est_rel_err", "diag/powersgd_recon_rel_err")
SHARDED = {**SKETCH, "topk_method": "threshold", "sketch_decode": "sharded"}
# the two-rank sessions: name -> Config keywords over BASE at 2 devices
TWO_RANK_TELEMETRY = {
    "sharded_l1": {**SHARDED, "telemetry_level": 1},
    "sharded_l2": {**SHARDED, "telemetry_level": 2},
    "true_topk_sparse_l1": {**TWO_RANK_CASES["true_topk_sparse"],
                            "telemetry_level": 1},
    **{f"{n}_l1": {**TWO_RANK_CASES[n], "telemetry_level": 1}
       for n in ("fsdp_sketch", "fsdp_true_topk", "fsdp_uncompressed")},
}


def _checker():
    """The reference's schema checker, loaded by path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", ROOT / "scripts" / "check_telemetry_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _diag(metrics):
    return {k: float(v) for k, v in metrics.items() if k.startswith("diag/")}


def _ref_diags(rounds_, kw, n_rounds=None):
    """(the reference session's initial state leaves, each round's diag
    dict)."""
    _, params, loss_ref, batches = rounds_
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_round, "shard_map",
                   _without_vma_check(ref_round.shard_map))
        cfg = RefConfig(**kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = RefSession(cfg, params, loss_ref)
            init = {n: np.asarray(getattr(ref.state, n)) for n in STATE_LEAVES}
            out = [_diag(ref.train_round(ids, _split(cfg, b), LR))
                   for ids, b in batches[:n_rounds]]
    return init, out


def _port_session(kw, params, init=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(Config(**kw, device="cpu"),
                                to_numpy_tree(params),
                                classification_loss(torch_tinymlp))
    if init is not None:
        sess.state = state_from_jax(init)
    return sess


def _port_rounds(sess, batches):
    return [sess.train_round(ids, microbatched(sess.cfg, b), LR)
            for ids, b in batches]


def _assert_diags(got, want):
    """Round by round: the same keys, the norms at rtol 1e-5 / atol 1e-6,
    the fidelity at rtol 1e-4 / atol 1e-6, the sentinel exactly."""
    assert len(got) == len(want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (r, sorted(g), sorted(w))
        for k, v in w.items():
            if k == "diag/nonfinite":
                assert g[k] == v == 0.0, (r, k)
                continue
            rtol = 1e-4 if k in FIDELITY else 1e-5
            np.testing.assert_allclose(g[k], v, rtol=rtol, atol=1e-6,
                                       err_msg=f"round {r} {k}")


# -- diagnostic twins ----------------------------------------------------------


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("case", sorted(TEL_MODES))
def test_diagnostic_twins_match_reference(rounds, case, level):
    kw = {**ONE, **TEL_MODES[case], "telemetry_level": level}
    init, want = _ref_diags(rounds, kw)
    sess = _port_session(kw, rounds[1], init)
    got = [_diag(m) for m in _port_rounds(sess, rounds[3])]
    _assert_diags(got, want)
    assert "diag/grad_norm" in got[0] and "diag/update_norm" in got[0]
    fid = [k for k in got[0] if k in FIDELITY]
    want_fid = ({"sketch": 1, "powersgd": 1}.get(kw["mode"], 0)
                if level == 2 else 0)
    assert len(fid) == want_fid, fid


@pytest.mark.parametrize("level", [1, 2])
def test_sharded_decode_diagnostics_one_device(rounds, level):
    kw = {**ONE, **SHARDED, "telemetry_level": level}
    init, want = _ref_diags(rounds, kw)
    sess = _port_session(kw, rounds[1], init)
    assert sess.sketch_decode_resolved == "sharded"
    _assert_diags([_diag(m) for m in _port_rounds(sess, rounds[3])], want)


@pytest.fixture(scope="module")
def telemetry_ranks(rounds, tmp_path_factory):
    two = {**BASE, "num_devices": 2}
    job = {"lr": LR, "telemetry": {n: {**two, **kw} for n, kw in
                                   TWO_RANK_TELEMETRY.items()}}
    return spawn(job, job_arrays(rounds), 2, tmp_path_factory)


@pytest.mark.parametrize("name", sorted(TWO_RANK_TELEMETRY))
def test_diagnostics_two_gloo_ranks_match_reference(rounds, telemetry_ranks,
                                                    name):
    """Both ranks hold the same scalars bit for bit, and they equal the
    reference's on its 2-device mesh."""
    prefix = f"tel:{name}/"
    keys = sorted(k for k in telemetry_ranks[0] if k.startswith(prefix))
    for k in keys:
        np.testing.assert_array_equal(telemetry_ranks[1][k],
                                      telemetry_ranks[0][k])
    got = [{k[len(prefix):]: float(telemetry_ranks[0][k][r]) for k in keys}
           for r in range(len(rounds[3]))]
    _, want = _ref_diags(rounds, {**BASE, "num_devices": 2,
                                  **TWO_RANK_TELEMETRY[name]})
    _assert_diags(got, want)


# -- level 0 -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["sketch", "local_topk_local_error",
                                  "powersgd"])
def test_level0_keys_unchanged_and_params_equal_at_every_level(rounds, case):
    """Level 0 builds nothing: its metrics are the loss and the loss
    function's aux, and the diagnostics change no value (params bit-equal
    at levels 0, 1 and 2)."""
    params = {}
    init, _ = _ref_diags(rounds, {**ONE, **TEL_MODES[case]}, n_rounds=0)
    for level in (0, 1, 2):
        kw = {**ONE, **TEL_MODES[case], "telemetry_level": level}
        sess = _port_session(kw, rounds[1], init)
        metrics = _port_rounds(sess, rounds[3])
        if level == 0:
            assert sorted(metrics[0]) == ["correct", "count", "loss"]
        else:
            # and the retrace sentinel's count, the reference's key at
            # level >= 1 (0.0: the per-round path captures nothing)
            assert {k for k in metrics[0] if not k.startswith("diag/")} == {
                "correct", "count", "loss", "xla/retraces"}
            assert metrics[0]["xla/retraces"] == 0.0
        params[level] = sess.state.params_vec.clone()
    assert torch.equal(params[0], params[1])
    assert torch.equal(params[0], params[2])


# -- the ledger, the run dir, divergence ----------------------------------------


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


def _loop_run(rounds_, kw, tmp_path, max_rounds=5):
    """``run_train_loop`` at level 1 with a ``MetricsWriter``: (the run
    dir, the session)."""
    ds, params, _, _ = rounds_
    cfg = Config(**{**ONE, **kw, "telemetry_level": 1, "num_epochs": 2,
                    "max_rounds": max_rounds}, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, to_numpy_tree(params),
                                classification_loss(torch_tinymlp))
    sampler = FedSampler(FedDataset(ds.data, BASE["num_clients"], iid=True,
                                    seed=0), num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size, seed=1)
    writer = MetricsWriter(str(tmp_path / "run"), cfg=cfg)
    try:
        run_train_loop(cfg, sess, sampler, _Hooks(), writer=writer)
    finally:
        writer.close()
    return tmp_path / "run", sess


@pytest.mark.parametrize("case", ["sketch", "local_topk_local_error",
                                  "powersgd"])
def test_ledger_is_exact_and_the_run_dir_passes_the_checker(rounds, tmp_path,
                                                            case):
    run_dir, sess = _loop_run(rounds, TEL_MODES[case], tmp_path)
    led = json.loads((run_dir / "comm_ledger.json").read_text())
    bpr = sess.bytes_per_round()
    assert led["rounds"] == 5 and led["bytes_per_round"] == bpr
    assert led["cum_up_bytes"] == 5 * bpr["upload_bytes"]
    assert led["cum_down_bytes"] == 5 * bpr["download_bytes"]
    assert "live_client_rounds" not in led
    _checker().validate_run_dir(run_dir)
    names = {json.loads(line).get("name")
             for line in (run_dir / "metrics.jsonl").read_text().splitlines()}
    assert {"train/loss", "lr", "diag/grad_norm", "diag/nonfinite",
            "comm/cum_bytes", "val/loss"} <= names


def test_masked_ledger_holds_the_live_invariant(rounds, tmp_path):
    kw = {**TEL_MODES["sketch"], "availability": "bernoulli",
          "dropout_prob": 0.3}
    run_dir, sess = _loop_run(rounds, kw, tmp_path)
    led = json.loads((run_dir / "comm_ledger.json").read_text())
    bpr = sess.bytes_per_round()
    rates = [json.loads(line) for line in
             (run_dir / "metrics.jsonl").read_text().splitlines()[1:]]
    live = sum(round(r["value"] * 8) for r in rates
               if r.get("name") == "fedsim/participation_rate")
    assert led["rounds"] == 5 and led["live_client_rounds"] == live < 40
    assert led["cum_up_bytes"] == live * bpr["upload_bytes"]
    assert led["cum_down_bytes"] == (led["avail_client_rounds"]
                                     * bpr["download_bytes"])
    assert all(isinstance(led[k], int) for k in led if k.startswith("cum"))
    _checker().validate_run_dir(run_dir)


def test_divergence_names_the_first_bad_round(tmp_path):
    """``nan_client@2``: a NaN transmit at round 2 poisons the params, the
    sentinel fires in round 2's drained record, and the run stops there
    with the flight record and the ledger written."""
    _write_cifar_pickles(str(tmp_path))
    logdir = tmp_path / "runs"
    with pytest.raises(DivergenceError) as exc:
        cv_train.main(["--mode", "uncompressed", "--num_clients", "4",
                       "--num_workers", "2", "--local_batch_size", "4",
                       "--num_epochs", "1", "--compute_dtype", "float32",
                       "--chaos", "nan_client@2", "--telemetry_level", "1",
                       "--dataset_dir", str(tmp_path), "--logdir",
                       str(logdir), "--device", "cpu"],
                      eval_batch_size=8, model_kw={"width": 4})
    assert exc.value.step == 2 and "round 2" in str(exc.value)
    (run_dir,) = logdir.iterdir()
    assert exc.value.path == str(run_dir / "flight_2.json")
    flight = json.loads((run_dir / "flight_2.json").read_text())
    assert flight["first_bad_step"] == 2
    assert [r["step"] for r in flight["records"]] == [0, 1, 2]
    assert flight["records"][-1]["scalars"]["diag/nonfinite"] == 1.0
    assert flight["records"][1]["scalars"]["diag/nonfinite"] == 0.0
    led = json.loads((run_dir / "comm_ledger.json").read_text())
    assert led["rounds"] == 3  # the drained rounds up to the bad one
    _checker().validate_run_dir(run_dir)


# -- the ops ---------------------------------------------------------------------


@pytest.mark.parametrize("r", [3, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_norm_estimates_match_reference_and_propagate_nan(r, dtype):
    table = np.random.default_rng(r).normal(size=(r, 257)).astype(np.float32)
    t_ref = jnp.asarray(table).astype(dtype)
    t_port = torch.from_numpy(table).to(getattr(torch, dtype))
    spec = port_cs.CountSketch(d=1000, c=257, r=r)
    np.testing.assert_allclose(
        float(port_cs.table_sqnorm_estimate(t_port)),
        float(ref_cs.table_sqnorm_estimate(t_ref)), rtol=1e-6)
    np.testing.assert_allclose(
        float(port_cs.l2_estimate(spec, t_port)),
        float(ref_cs.l2_estimate(None, t_ref)), rtol=1e-6)
    table[1, 7] = np.nan
    assert math.isnan(float(port_cs.table_sqnorm_estimate(
        torch.from_numpy(table))))
    assert math.isnan(float(port_cs.l2_estimate(spec,
                                                torch.from_numpy(table))))
    assert math.isnan(float(ref_cs.table_sqnorm_estimate(
        jnp.asarray(table))))


@pytest.mark.parametrize("bad", [None, "nan", "inf", "-inf"])
def test_nonfinite_sentinel_matches_reference(bad):
    """One non-finite element anywhere in a vector, or in a scalar, fires
    the sentinel, as the reference's; ``all_finite``'s one-read form
    equals ``isfinite(v).all()``."""
    from commefficient_tpu.telemetry.diagnostics import (
        nonfinite_sentinel as ref_sentinel,
    )
    from commefficient_tpu_torch.telemetry import nonfinite_sentinel
    from commefficient_tpu_torch.telemetry.diagnostics import all_finite

    rng = np.random.default_rng(3)
    for pos in rng.integers(0, 1000, size=4):
        v = rng.normal(size=1000).astype(np.float32)
        if bad is not None:
            v[pos] = float(bad)
        t = torch.from_numpy(v)
        assert bool(all_finite(t)) == bool(torch.isfinite(t).all())
        for scalars in ([1.0, 2.0], [1.0, float(bad or 0.0)]):
            got = nonfinite_sentinel([torch.tensor(x) for x in scalars], (t,))
            want = ref_sentinel([jnp.float32(x) for x in scalars],
                                vecs=(jnp.asarray(v),))
            assert float(got) == float(want)
        assert float(got) == (bad is not None)


def test_mask_out_indices_matches_reference():
    v = np.random.default_rng(0).normal(size=50).astype(np.float32)
    idx = np.array([3, 7, 7, 49])
    want = np.asarray(ref_topk.mask_out_indices(jnp.asarray(v),
                                                jnp.asarray(idx)))
    got = port_topk.mask_out_indices(torch.from_numpy(v),
                                     torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


# -- host units --------------------------------------------------------------------


def test_pack_metric_dicts_packs_and_refuses_mixed_key_sets():
    dicts = [{"loss": torch.tensor(float(i)), "fedsim/dropped": 2.0 * i}
             for i in range(3)]
    names, mat = pack_metric_dicts(dicts)
    assert names == ("fedsim/dropped", "loss")
    np.testing.assert_array_equal(mat, [[0, 0], [2, 1], [4, 2]])
    with pytest.raises(ValueError, match="dict 1 has"):
        pack_metric_dicts([{"loss": 1.0}, {"loss": 1.0, "diag/x": 0.0}])


def test_metrics_writer_stringifies_non_finite_values(tmp_path):
    cfg = Config(device="cpu", profile_dir="prof")
    w = MetricsWriter(str(tmp_path), cfg=cfg)
    for step, v in enumerate([1.5, float("nan"), float("inf"),
                              -float("inf")]):
        w.scalar("diag/x", v, step)
    w.close()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    header = json.loads(lines[0])
    assert header["type"] == "header" and header["schema_version"] == 13
    assert header["backend"] == "cpu" and header["device_kind"] == "cpu"
    assert header["artifacts"] == {"profile_dir": "prof"}
    assert run_artifacts(Config(device="cpu"), str(tmp_path)) == {}
    vals = [json.loads(line, parse_constant=pytest.fail)["value"]
            for line in lines[1:]]
    assert vals == [1.5, "nan", "inf", "-inf"]
    assert all("t" in json.loads(line) for line in lines[1:])
    assert jsonable_tree({"a": [float("nan"), 2.0]}) == {"a": ["nan", 2.0]}


def test_step_profiler_window_matches_reference(monkeypatch, tmp_path):
    """The same step sequences (a window, a resume past it, a resume into
    it, start 0 clamped) open and close the trace at the same steps as
    the reference's ``StepProfiler``, whose jax trace calls are
    recorded instead of run."""
    from commefficient_tpu.utils import profiling as ref_prof

    monkeypatch.setattr(ref_prof.jax.profiler, "start_trace",
                        lambda *_: None)
    monkeypatch.setattr(ref_prof.jax.profiler, "stop_trace", lambda: None)
    for args, resume, steps in [((5, 3), None, range(12)),
                                ((0, 2), None, range(6)),
                                ((5, 3), 6, range(6, 14)),
                                ((5, 3), 3, range(3, 12))]:
        ref = ref_prof.StepProfiler(str(tmp_path / "ref"), *args)
        port = StepProfiler(str(tmp_path / "port"), *args)
        if resume is not None:
            ref.resume_at(resume)
            port.resume_at(resume)
        for s in steps:
            ref.step(s)
            port.step(s)
            assert port.active == ref._active, (args, resume, s)
        port.close()
    traces = list((tmp_path / "port").glob("*.pt.trace.json"))
    assert len(traces) == 4 and json.loads(traces[0].read_text())
    idle = StepProfiler("")
    idle.step(5)
    assert not idle.active


def test_fence_and_timeit(capsys):
    from commefficient_tpu_torch.utils.profiling import fence, timeit

    x = {"a": [torch.arange(3.0) + 2.0]}
    assert fence(x) == 2.0
    calls = []
    ms = timeit("probe", lambda: calls.append(1) or torch.ones(2), reps=4)
    assert ms >= 0 and len(calls) == 2 + 4
    assert "probe" in capsys.readouterr().out


def test_flight_recorder_ring_rewind_and_dump(tmp_path):
    fr = FlightRecorder(Config(device="cpu"), logdir=str(tmp_path), window=3)
    for s in range(5):
        fr.record(s, 0.1, {"loss": 1.0, "diag/nonfinite": 0.0})
        fr.check(s, 1.0, {"diag/nonfinite": 0.0})
    assert [r["step"] for r in fr.records] == [2, 3, 4]
    fr.rewind(4)
    assert [r["step"] for r in fr.records] == [2, 3] and fr.last_step == 3
    fr.record(4, 0.1, {"loss": float("nan")})
    with pytest.raises(DivergenceError, match="round 4") as exc:
        fr.check(4, float("nan"), {"diag/nonfinite": 1.0})
    rec = json.loads(Path(exc.value.path).read_text())
    assert rec["records"][-1]["scalars"]["loss"] == "nan"
    assert "controller" not in rec and "recovery_history" not in rec
    assert fr.on_exception(RuntimeError("boom")).endswith("flight_4.json")
    _checker().validate_flight(exc.value.path)
    assert FlightRecorder(Config(device="cpu")).dump(
        1, reason="x", first_bad_step=None) is None


def test_comm_ledger_snapshot_round_trip():
    class Comp:
        def upload_bytes_per_float(self):
            return 2

        def masked_upload_floats(self, live):
            return 10 * live

    led = CommLedger({"upload_floats": 10, "download_floats": 30,
                      "upload_bytes": 20, "download_bytes": 120},
                     mode="sketch", num_workers=4, masked=True,
                     compressor=Comp())
    led.on_round(0, {"fedsim/participation_rate": 0.75,
                     "fedsim/dropped": 1.0})
    snap = led.snapshot_state()
    out = led.on_round(1, {})
    assert out["comm/up_bytes"] == 80 and out["comm/down_bytes"] == 480
    led.load_snapshot_state(snap)
    assert led.snapshot_state() == snap == {
        "rounds": 1, "cum_up_bytes": 60, "cum_down_bytes": 360,
        "live_client_rounds": 3, "avail_client_rounds": 3}
    # a ladder's ledger: per-rung counters ride the snapshot, and a
    # snapshot of another ladder is refused, as the reference's is
    bpr1 = {"upload_floats": 5, "download_floats": 30, "upload_bytes": 10,
            "download_bytes": 120}
    led = CommLedger(bpr1, mode="sketch", num_workers=4,
                     rungs=[(bpr1, Comp()), ({**bpr1, "upload_bytes": 4},
                                             Comp())])
    led.on_round(0, {"control/rung": 1.0})
    snap = led.snapshot_state()
    led.on_round(1, {"control/rung": 0.0})
    led.load_snapshot_state(snap)
    assert led.snapshot_state() == snap and snap["cum_up_bytes"] == 4
    assert [r["rounds"] for r in snap["rungs"]] == [0, 1]
    with pytest.raises(ValueError, match="rung count"):
        led.load_snapshot_state({**snap, "rungs": snap["rungs"][:1]})

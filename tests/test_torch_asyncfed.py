"""The port's buffered-asynchronous federation (``commefficient_tpu_torch/
asyncfed/``, ``pipeline/cohorts.py`` and ``control/``'s ``staleness_aware``
policy) against the reference, on the CPU, at TinyMLP size (the
reference's ``tests/test_asyncfed.py`` BASE: 12 clients, W = 8, batch 4,
seed 5).

* ``AsyncSchedule`` and ``cohort_delays`` equal to the reference's for the
  same arguments (``updates``, ``launch_version``, ``num_cohorts``,
  ``launched_before``), over seeds, widths, K, C and rates, ``inf``
  included;
* every ``Config`` refusal of the flags with the reference's message;
* the anchor (K = W, C = 1, alpha = 0) BIT-EQUAL to the port's synchronous
  round: uncompressed, sketch, true_topk and local_topk, under fedsim
  masking and with DP noise (params, every leaf, every loss);
* an overlapped run (K 4, C 3, alpha 0.5, poisson 0.9) against the
  reference's ``AsyncFederation`` from its initial params: losses and
  params ``rtol 1e-4 / atol 1e-5``, tables ``1e-5 * max|table|``, the
  ``async/*`` and ``fedsim/*`` scalars equal; local_topk too, where two
  consumed cohorts share clients;
* the vault's riders: a snapshot and restore replay bit for bit, a cold
  restart is deterministic (and at the anchor the unbroken run);
* double buffering: the anchor bit-equal with its spans (dispatch and
  drain), ``close`` and ``snapshot_extra`` drain the parked fence;
* through ``run_train_loop``: at C = 1 the ledger bills the synchronous
  bytes and ``perf_report.json`` has ``engine: "async"`` with its block
  (the reference's schema checker passes the run dir); a ``retry``
  recovery through the runner bit-equal to the unbroken run; a checkpoint
  resume deterministic; ``cv_train.main --async_buffer`` runs;
* ``staleness_aware``: ``decide`` and ``decide_async`` equal to the
  reference's on one scalar stream; an engine run that switches rungs and
  retunes (K, C) with every rung's pair built by the prewarm; the
  controller blob round-trips;
* the write-back of duplicate client ids: the last live slot wins.
"""

import importlib.util
import json
import math
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import commefficient_tpu.control.policy as ref_policy
from commefficient_tpu.asyncfed import AsyncFederation as RefAsync
from commefficient_tpu.asyncfed import AsyncSchedule as RefSchedule
from commefficient_tpu.asyncfed import cohort_delays as ref_delays
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.utils.config import Config as RefConfig
import commefficient_tpu_torch.control.policy as port_policy
from commefficient_tpu_torch.asyncfed import (
    ASYNC_STREAM,
    AsyncFederation,
    AsyncSchedule,
    cohort_delays,
)
from commefficient_tpu_torch.asyncfed.round import write_back
from commefficient_tpu_torch.control import build_controller, controller_header
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.telemetry.spans import PhaseSpans
from commefficient_tpu_torch.train.cv_train import _CvHooks
from commefficient_tpu_torch.train.runner import run_train_loop
from commefficient_tpu_torch.utils.config import Config
from commefficient_tpu_torch.utils.logging import MetricsWriter
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_round import _write_cifar_pickles

ROOT = Path(__file__).resolve().parents[1]
ONE = {**BASE, "num_devices": 1}
LR = 0.3
N_ROUNDS = 3
MODES = {
    "uncompressed": dict(mode="uncompressed"),
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=20, num_rows=3, num_cols=200),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=20),
    "local_topk": dict(mode="local_topk", error_type="local", k=20,
                       local_momentum=0.9),
}
ANCHOR = dict(async_buffer=8, async_concurrency=1, staleness_exponent=0.0)
OVERLAP = dict(async_buffer=4, async_concurrency=3, staleness_exponent=0.5,
               availability="poisson", arrival_rate=0.9)
ASYNC_KEYS = ("async/staleness_mean", "async/staleness_max",
              "async/buffer_fill", "async/concurrent_cohorts",
              "async/effective_participation")
LEAVES = ("params_vec", "momentum", "error", "client_vel", "client_err",
          "comp")


@pytest.fixture(scope="module")
def data():
    """(the reference's dataset, its initial params as numpy)."""
    ds, params, _ = _setup(BASE["num_clients"])
    return ds, to_numpy_tree(params)


def _session(data, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return FederatedSession(Config(**{**ONE, **kw, "device": "cpu"}),
                                data[1], classification_loss(torch_tinymlp))


def _sampler(data, cfg):
    return FedSampler(FedDataset(data[0].data, cfg.num_clients, iid=True,
                                 seed=0), num_workers=cfg.num_workers,
                      local_batch_size=cfg.sampler_batch_size, seed=1)


def _sync(data, kw, n=N_ROUNDS):
    sess = _session(data, **kw)
    sampler = _sampler(data, sess.cfg)
    losses = [float(sess.train_round(*sampler.sample_round(r), LR)["loss"])
              for r in range(n)]
    return sess, losses


def _engine(sess, sampler, n):
    return AsyncFederation(sess.cfg, sess, sampler, lambda s: LR, n,
                           steps_per_epoch=n)


def _async(data, kw, n=N_ROUNDS, spans=None, cut=None, blob=True):
    """An engine run of ``n`` updates: (session, metrics, engine). With
    ``cut``, the run stops after update ``cut - 1`` and restarts at
    ``cut``, from its snapshot window (``blob``) or cold."""
    sess = _session(data, **kw)
    sess.spans = spans
    eng = _engine(sess, _sampler(data, sess.cfg), n).start()
    recs = []
    try:
        for step, _lr, m, *_ in eng.epoch_rounds(0, 0, n):
            recs.append(m)
            if step + 1 == cut:
                break
        if cut is not None:
            if blob:
                extra = eng.snapshot_extra()
                assert extra["update"] == cut and eng._deferred is None
                eng.restore_extra(extra)
            eng.restart(cut)
            recs += [m for *_, m, _w, _t in eng.epoch_rounds(0, cut, n)]
    finally:
        eng.close()
    return sess, recs, eng


def _losses(recs):
    return [float(m["loss"]) for m in recs]


def _assert_leaves_equal(a, b):
    for leaf in LEAVES:
        x, y = getattr(a.state, leaf), getattr(b.state, leaf)
        assert (x is None) == (y is None), leaf
        if torch.is_tensor(x):
            assert torch.equal(x, y), leaf


def _ref_async(data, kw, n):
    """The reference's ``AsyncFederation`` at one device: (session,
    metrics)."""
    ds, _ = data
    cfg = RefConfig(**{**ONE, **kw})
    _, params, loss_ref = _setup(BASE["num_clients"])
    sess = RefSession(cfg, params, loss_ref)
    sampler = RefSampler(ds, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size, seed=1)
    eng = RefAsync(cfg, sess, sampler, lambda s: LR, n,
                   steps_per_epoch=n).start()
    try:
        recs = [m for _s, _lr, m in eng.epoch_rounds(0, 0)]
    finally:
        eng.close()
    return sess, recs


def _checker():
    """The reference's schema checker, loaded by path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", ROOT / "scripts" / "check_telemetry_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (1) the schedule ------------------------------------------------------------


@pytest.mark.parametrize("seed,W,K,C,rate", [
    (5, 8, 8, 1, 1.0), (5, 8, 8, 1, math.inf), (5, 8, 4, 3, 0.9),
    (7, 8, 3, 2, 1.5), (0, 8, 5, 1, 2.0), (1, 4, 4, 2, math.inf),
    (2, 4, 1, 4, 0.5), (3, 8, 8, 3, 2.0), (42, 8, 4, 2, 0.9),
    (11, 6, 2, 5, 3.0)])
def test_schedule_equals_the_reference(seed, W, K, C, rate):
    kw = dict(seed=seed, num_workers=W, buffer_k=K, concurrency=C,
              arrival_rate=rate, num_updates=12)
    got, want = AsyncSchedule(**kw), RefSchedule(**kw)
    assert got.updates == want.updates
    assert got.launch_version == want.launch_version
    assert got.num_cohorts == want.num_cohorts
    assert [got.launched_before(u) for u in range(12)] == \
        [want.launched_before(u) for u in range(12)]
    for c in range(3):
        np.testing.assert_array_equal(cohort_delays(seed, c, W, rate),
                                      ref_delays(seed, c, W, rate))


def test_schedule_stream_tag_and_refusals_as_the_reference():
    from commefficient_tpu.asyncfed import ASYNC_STREAM as REF_STREAM

    assert ASYNC_STREAM == REF_STREAM
    for kw in (dict(buffer_k=0, concurrency=1), dict(buffer_k=9,
                                                      concurrency=1),
               dict(buffer_k=4, concurrency=0)):
        args = dict(seed=5, num_workers=8, arrival_rate=1.0, num_updates=3,
                    **kw)
        with pytest.raises(ValueError) as port:
            AsyncSchedule(**args)
        with pytest.raises(ValueError) as ref:
            RefSchedule(**args)
        assert str(port.value) == str(ref.value)


# -- (2) Config --------------------------------------------------------------------


CONFIG_REFUSALS = [
    dict(async_buffer=-1),
    dict(async_buffer=9),
    dict(async_buffer=4, async_concurrency=0),
    dict(async_buffer=4, staleness_exponent=-0.5),
    dict(async_concurrency=2),
    dict(staleness_exponent=0.5),
    dict(async_double_buffer=True),
    dict(async_buffer=4, fuse_clients=True),
    dict(async_buffer=4, mode="sketch", k=20, num_rows=3, num_cols=200,
         error_type="virtual", fuse_clients=True, sketch_fused_bwd=True),
    dict(async_buffer=4, local_momentum=0.9, client_store="host"),
    dict(async_buffer=4, mode="true_topk", error_type="virtual",
         topk_method="threshold", fsdp=True),
    dict(async_buffer=4, scan_rounds=2, mode="sketch", k=20, num_rows=3,
         num_cols=200, error_type="virtual"),
    dict(async_buffer=4, pipeline_depth=2),
    dict(async_buffer=4, preempt_signals=True),
    dict(async_buffer=4, chaos="preempt@2"),
]


@pytest.mark.parametrize("kw", CONFIG_REFUSALS)
def test_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as port:
        Config(**{**BASE, **kw})
    with pytest.raises(ValueError) as ref:
        RefConfig(**{**BASE, **kw})
    assert str(port.value) == str(ref.value)


def test_config_accepts_the_flags_and_keeps_the_fleet_refused():
    cfg = Config(**BASE, **ANCHOR, async_double_buffer=True)
    assert cfg.asyncfed_enabled and not Config(**BASE).asyncfed_enabled
    # the elastic fleet is ported; with asyncfed it stays refused, in the
    # reference's words
    with pytest.raises(ValueError, match="fleet events are incompatible "
                       "with async_buffer > 0") as port:
        Config(**{**BASE, "num_devices": 1}, async_buffer=4,
               chaos="resize@4:rounds=1-1")
    with pytest.raises(ValueError) as ref:
        RefConfig(**{**BASE, "num_devices": 1}, async_buffer=4,
                  chaos="resize@4:rounds=1-1")
    assert str(port.value) == str(ref.value)


# -- (3) the anchor ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    MODES["uncompressed"], MODES["sketch"], MODES["true_topk"],
    MODES["local_topk"],
    dict(MODES["sketch"], availability="bernoulli", dropout_prob=0.4),
    dict(MODES["uncompressed"], max_grad_norm=1.0, dp_noise_multiplier=0.5),
], ids=["uncompressed", "sketch", "true_topk", "local_topk",
        "sketch_fedsim", "uncompressed_dp"])
def test_anchor_bit_equal_to_the_sync_round(data, kw):
    sync, losses = _sync(data, kw)
    sess, recs, eng = _async(data, {**kw, **ANCHOR})
    assert _losses(recs) == losses
    _assert_leaves_equal(sess, sync)
    assert eng.stats()["updates"] == N_ROUNDS
    assert eng.stats()["cohorts_launched"] == N_ROUNDS
    for m in recs:
        assert m["async/staleness_mean"] == 0.0
        assert m["async/effective_participation"] == float(
            m.get("fedsim/participation_rate", 1.0) * 8)


# -- (4) overlap against the reference ------------------------------------------------


@pytest.mark.parametrize("mode", ["sketch", "local_topk"])
def test_overlap_matches_the_reference(data, mode):
    kw = {**MODES[mode], **OVERLAP}
    n = 8
    sess, recs, eng = _async(data, kw, n=n)
    ref, rrecs = _ref_async(data, kw, n)
    np.testing.assert_allclose(_losses(recs), [float(np.asarray(
        m["loss"])) for m in rrecs], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec),
                               rtol=1e-4, atol=1e-5)
    for key in ASYNC_KEYS + ("fedsim/participation_rate", "fedsim/dropped"):
        assert [m[key] for m in recs] == [float(np.asarray(m[key]))
                                          for m in rrecs], key
    assert max(m["async/staleness_mean"] for m in recs) > 0
    for leaf in ("momentum", "error", "client_vel", "client_err"):
        x, y = getattr(sess.state, leaf), getattr(ref.state, leaf)
        if x is None or not np.asarray(y).size:
            continue
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-5 * max(np.abs(y).max(), 1e-30))
    st = eng.stats()
    assert st["updates"] == n and st["window_cohorts_max"] >= 2


# -- (5) the vault's riders ------------------------------------------------------------


def test_snapshot_restore_replays_bit_identically(data):
    kw = dict(MODES["uncompressed"], async_buffer=4, async_concurrency=2,
              staleness_exponent=0.5, arrival_rate=2.0)
    ref_sess, ref_recs, _ = _async(data, kw, n=6)
    sess, recs, eng = _async(data, kw, n=6, cut=3)
    assert _losses(recs) == _losses(ref_recs)
    _assert_leaves_equal(sess, ref_sess)
    st = eng.stats()
    assert st["restarts"] == 1 and st["snapshot_bytes"] > 0


def test_cold_restart_is_deterministic(data):
    kw = dict(MODES["local_topk"], async_buffer=4, async_concurrency=2,
              staleness_exponent=0.5, arrival_rate=2.0)
    a, ra, _ = _async(data, kw, n=6, cut=3, blob=False)
    b, rb, _ = _async(data, kw, n=6, cut=3, blob=False)
    assert _losses(ra) == _losses(rb)
    _assert_leaves_equal(a, b)
    # at the anchor a cold restart relaunches nothing in flight: it is
    # the unbroken run
    kw = {**MODES["uncompressed"], **ANCHOR}
    straight, _, _ = _async(data, kw, n=4)
    cold, _, _ = _async(data, kw, n=4, cut=2, blob=False)
    _assert_leaves_equal(cold, straight)


# -- (6) double buffering -----------------------------------------------------------


def test_double_buffer_anchor_bit_equal_and_drains(data, tmp_path):
    kw = MODES["sketch"]
    sync, losses = _sync(data, kw)
    spans = PhaseSpans(str(tmp_path), start_step=0, num_steps=N_ROUNDS)
    sess, recs, eng = _async(data, {**kw, **ANCHOR,
                                    "async_double_buffer": True},
                             spans=spans)
    assert _losses(recs) == losses
    _assert_leaves_equal(sess, sync)
    assert eng._deferred is None, "close() left a parked fence"
    names = [ev["name"] for ev in spans.events]
    assert names.count("async_apply_dispatch") == N_ROUNDS
    assert names.count("async_apply_drain") == N_ROUNDS
    assert "async_apply" not in names
    assert names.count("async_launch") == N_ROUNDS
    # the twin without double buffering records plain applies
    spans2 = PhaseSpans(str(tmp_path / "b"), start_step=0,
                        num_steps=N_ROUNDS)
    _async(data, {**kw, **ANCHOR}, spans=spans2)
    names2 = [ev["name"] for ev in spans2.events]
    assert names2.count("async_apply") == N_ROUNDS
    assert "async_apply_drain" not in names2
    residency = [ev for ev in spans2.events
                 if ev["name"] == "async_buffer_residency"]
    assert [ev["args"]["trace_id"] for ev in residency] == ["c0", "c1", "c2"]


def test_double_buffer_snapshot_replays_bit_identically(data, tmp_path):
    kw = dict(MODES["uncompressed"], async_buffer=4, async_concurrency=2,
              staleness_exponent=0.5, arrival_rate=2.0,
              async_double_buffer=True)
    spans = PhaseSpans(str(tmp_path / "a"), start_step=0, num_steps=6)
    ref_sess, ref_recs, _ = _async(data, kw, n=6, spans=spans)
    spans = PhaseSpans(str(tmp_path / "b"), start_step=0, num_steps=6)
    sess, recs, _ = _async(data, kw, n=6, spans=spans, cut=3)
    assert _losses(recs) == _losses(ref_recs)
    _assert_leaves_equal(sess, ref_sess)


# -- (7) through the runner -------------------------------------------------------------


LOOP = dict(MODES["sketch"], telemetry_level=1, num_epochs=1,
            pivot_epoch=1, lr_scale=0.1)


def _loop(data, tmp_path, tag, stats=None, **kw):
    """One run of ``run_train_loop`` with cv_train's hooks (9 rounds an
    epoch): (session, run dir, history)."""
    sess = _session(data, **{**LOOP, **kw})
    cfg = sess.cfg
    ds = data[0]
    test_ds = FedDataset({"x": ds.data["x"][:40], "y": ds.data["y"][:40]},
                         1, seed=0)
    run_dir = str(tmp_path / f"run{tag}")
    writer = MetricsWriter(run_dir, cfg=cfg,
                           extra_header=controller_header(sess))
    try:
        _, history, _ = run_train_loop(
            cfg, sess, _sampler(data, cfg), _CvHooks(sess, test_ds, 32),
            writer=writer, engine_stats=stats)
    finally:
        writer.close()
    return sess, run_dir, history


def test_anchor_ledger_bills_the_sync_bytes_and_the_audit(data, tmp_path):
    ledgers, reports, runs = {}, {}, {}
    for tag, extra in (("sync", {}), ("async", ANCHOR)):
        sess, run_dir, hist = _loop(data, tmp_path, tag, **extra)
        runs[tag] = (sess, hist)
        with open(os.path.join(run_dir, "comm_ledger.json")) as f:
            ledgers[tag] = json.load(f)
        with open(os.path.join(run_dir, "perf_report.json")) as f:
            reports[tag] = json.load(f)
        _checker().validate_run_dir(run_dir)
    for key in ("rounds", "cum_up_bytes", "cum_down_bytes", "cum_bytes"):
        assert ledgers["async"][key] == ledgers["sync"][key], key
    assert reports["async"]["engine"] == "async"
    assert reports["async"]["async"] == {
        "buffer": 8, "concurrency": 1, "staleness_exponent": 0.0}
    assert reports["sync"]["engine"] == "replicated"
    assert "async" not in reports["sync"]
    assert [h["loss"] for h in runs["async"][1]] == \
        [h["loss"] for h in runs["sync"][1]]
    _assert_leaves_equal(runs["async"][0], runs["sync"][0])


def test_retry_recovery_through_the_runner_is_bit_equal(data, tmp_path):
    kw = dict(async_buffer=4, async_concurrency=2, staleness_exponent=0.5,
              availability="poisson", arrival_rate=0.9,
              recover_policy="retry", snapshot_every=4)
    clean, _, hist = _loop(data, tmp_path, "clean", **kw)
    stats = {}
    healed, _, healed_hist = _loop(data, tmp_path, "nan", stats=stats,
                                   chaos="nan_client@5", **kw)
    assert healed.resilience.manager.recoveries == 1
    assert stats["restarts"] == 1
    assert [h["loss"] for h in healed_hist] == [h["loss"] for h in hist]
    _assert_leaves_equal(healed, clean)


def test_checkpoint_resume_is_deterministic(data, tmp_path):
    kw = dict(async_buffer=4, async_concurrency=2, staleness_exponent=0.5,
              arrival_rate=2.0)
    finals = []
    for tag in ("a", "b"):
        ck = str(tmp_path / f"ck{tag}")
        _loop(data, tmp_path, f"{tag}0", checkpoint_dir=ck,
              checkpoint_every=4, max_rounds=4, **kw)
        sess, _, hist = _loop(data, tmp_path, f"{tag}1", checkpoint_dir=ck,
                              resume=True, max_rounds=8, **kw)
        assert [h["step"] for h in hist] == list(range(4, 8))
        finals.append((sess, [h["loss"] for h in hist]))
    assert finals[0][1] == finals[1][1]
    _assert_leaves_equal(finals[0][0], finals[1][0])


def test_cv_train_runs_with_async_buffer(tmp_path):
    """The entry point a user calls, on a tiny CIFAR-10 pickle set (40
    training images: 5 updates of 4 clients x 2) at a narrow width."""
    from commefficient_tpu_torch.train import cv_train

    _write_cifar_pickles(str(tmp_path))
    out = cv_train.main([
        "--mode", "sketch", "--k", "50", "--num_rows", "3", "--num_cols",
        "500", "--virtual_momentum", "0.9", "--error_type", "virtual",
        "--num_workers", "4", "--num_clients", "8", "--local_batch_size",
        "2", "--async_buffer", "2", "--async_concurrency", "2",
        "--staleness_exponent", "0.5", "--max_rounds", "3", "--device",
        "cpu", "--dataset_dir", str(tmp_path), "--logdir",
        str(tmp_path / "runs")], eval_batch_size=8, model_kw={"width": 2})
    assert len(out["history"]) == 3
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    assert out["data_path"] == "host"
    assert out["pipeline_stats"]["updates"] == 3


# -- (8) staleness_aware ---------------------------------------------------------------


SA = dict(mode="true_topk", error_type="virtual", telemetry_level=1,
          control_policy="staleness_aware", ladder="k=30,20,10",
          async_buffer=4, async_concurrency=3, control_hysteresis=2,
          control_staleness_hi=0.6, control_staleness_lo=0.2)


def _sa_stream(seed, n):
    rng = np.random.default_rng(seed)
    return [(float(rng.choice([0.0, 0.1, 0.4, 1.0, 3.0])),
             float(rng.integers(0, 12))) for _ in range(n)]


def _drive_sa(pkg, cfg, stream):
    """The controller's loop around the policy, without a session: each
    update's rung and (K, C)."""
    pol = pkg.get_policy(cfg)
    rung, last, k, c, last_rt, out = 0, -1, 4, 3, -1, []
    for step, (stale, fill) in enumerate(stream):
        ctx = pkg.DecisionContext(
            step=step, num_rounds=len(stream), rung=rung, num_rungs=3,
            round_bytes=lambda r: [300, 200, 100][r], spent_bytes=0,
            budget_bytes=None, last_switch_round=last,
            hysteresis=cfg.control_hysteresis, staleness_mean=stale,
            effective_participation=4.0, buffer_fill=fill, num_workers=8)
        nxt = min(max(int(pol.decide(ctx)), 0), 2)
        if nxt != rung:
            rung, last = nxt, step
        if last_rt < 0 or step - last_rt >= cfg.control_hysteresis:
            k2, c2 = pol.decide_async(ctx, k, c)
            k2, c2 = min(max(k2, 1), 8), max(c2, 1)
            if (k2, c2) != (k, c):
                k, c, last_rt = k2, c2, step
        out.append((rung, k, c))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_staleness_aware_decides_as_the_reference(seed):
    stream = _sa_stream(seed, 40)
    got = _drive_sa(port_policy, Config(**BASE, **SA), stream)
    want = _drive_sa(ref_policy, RefConfig(**BASE, **SA), stream)
    assert got == want
    assert len({g[0] for g in got}) > 1 and len({g[1:] for g in got}) > 1
    assert port_policy.StalenessAwarePolicy.ADAPTS_ASYNC
    assert not port_policy.ControlPolicy.ADAPTS_ASYNC


def test_staleness_aware_engine_switches_retunes_and_blob(data):
    cfg_kw = dict(SA, ladder="k=30,20", control_hysteresis=1,
                  availability="poisson", arrival_rate=0.9)
    sess = _session(data, **cfg_kw)
    ctl = build_controller(sess.cfg, sess, num_rounds=10)
    assert ctl.prewarm() == 2 and sorted(sess._async_fns) == [0, 1]
    pairs = dict(sess._async_fns)
    eng = _engine(sess, _sampler(data, sess.cfg), 10).start()
    recs = []
    try:
        recs = [m for *_, m, _w, _t in eng.epoch_rounds(0, 0, 10)]
    finally:
        eng.close()
    assert all(np.isfinite(float(m["loss"])) for m in recs)
    assert ctl.switches >= 1 and ctl.retunes >= 1
    assert eng.stats()["retunes_applied"] >= 1 and eng.quiesces >= 1
    ks = {m["control/async_k"] for m in recs}
    assert len(ks) > 1 or len({m["control/async_c"] for m in recs}) > 1
    assert sess._async_fns == pairs, "a switch or a retune built a pair"
    extra = eng.snapshot_extra()
    assert (extra["k"], extra["c"]) == (eng._k, eng._c)
    sess2 = _session(data, **cfg_kw)
    ctl2 = build_controller(sess2.cfg, sess2, num_rounds=10)
    ctl2.load_state_blob(ctl.state_blob())
    np.testing.assert_array_equal(ctl2.state_blob(), ctl.state_blob())
    eng2 = _engine(sess2, _sampler(data, sess2.cfg), 10)
    assert (eng2._k, eng2._c) == (ctl.async_k, ctl.async_c)
    eng2.close()


def test_fixed_policy_async_run_has_no_retune_scalars(data):
    sess = _session(data, mode="true_topk", error_type="virtual",
                    telemetry_level=1, control_policy="fixed",
                    control_schedule="0-=0", ladder="k=30,20",
                    async_buffer=4, async_concurrency=2)
    build_controller(sess.cfg, sess, num_rounds=4)
    sess2, recs, eng = sess, [], _engine(sess, _sampler(data, sess.cfg), 4)
    eng.start()
    try:
        recs = [m for *_, m, _w, _t in eng.epoch_rounds(0, 0, 4)]
    finally:
        eng.close()
    assert recs and all("control/async_k" not in m for m in recs)
    assert eng.stats()["retunes_applied"] == 0


# -- (9) the write-back --------------------------------------------------------------


def test_write_back_last_live_slot_wins():
    bank = torch.zeros(5, 3)
    ids = np.array([2, 4, 2, 1, 4, 2], np.int64)
    w = np.array([1.0, 0.5, 0.7, 0.0, 0.0, 0.0], np.float32)
    rows = torch.arange(18, dtype=torch.float32).reshape(6, 3)
    write_back(bank, ids, w, rows)
    # client 2: slots 0 and 2 live, 5 dead -> slot 2; client 4: slot 1
    # live, 4 dead -> slot 1; client 1: dead -> untouched
    want = torch.zeros(5, 3)
    want[2], want[4] = rows[2], rows[1]
    assert torch.equal(bank, want)
    write_back(None, ids, w, rows)  # an absent bank: nothing


# -- profile_round's async phase lines ------------------------------------------------

ASYNC_LINES = ("[async arrival]", "[async launch]", "[async apply]",
               "[async sequential]", "[async double-buffer]")


def _lines_inputs(sess, data, step=0):
    """Round ``step``'s cohort as profile_round hands it to the lines:
    device ids, this rank's microbatched clients, the host ids."""
    from commefficient_tpu_torch.parallel.api import _to_device, microbatched

    host_ids, raw = _sampler(data, sess.cfg).sample_round(step)
    batch = _to_device(sess.local_clients(microbatched(sess.cfg, raw)),
                       sess.device)
    return torch.as_tensor(host_ids.astype(np.int64)), batch, host_ids


def test_profile_round_takes_async_buffer(monkeypatch):
    """``--async_buffer`` is no longer refused: the flags reach the
    session (here a stand-in that stops the run)."""
    from commefficient_tpu_torch.train import profile_round

    class Reached(Exception):
        pass

    def stop(cfg, *a, **k):
        raise Reached(cfg)

    monkeypatch.setattr(profile_round.cv_train, "build_model_and_data",
                        lambda cfg: (None,) * 6)
    monkeypatch.setattr(profile_round, "FederatedSession", stop)
    with pytest.raises(Reached) as got:
        profile_round.main(["--async_buffer", "4", "--async_concurrency",
                            "2", "--device", "cpu"])
    cfg = got.value.args[0]
    assert (cfg.async_buffer, cfg.async_concurrency) == (4, 2)


def test_async_lines_pair_equals_one_async_federation_update(data):
    """The lines' launch and apply (K = W / 2, C = 2, alpha 0.5, every
    weight 1), called as ``async_lines`` calls them, leave the state of
    one ``AsyncFederation`` update at the anchor (K = W, C = 1, alpha 0,
    whose weights are all 1) on the same cohort, bit for bit."""
    from commefficient_tpu_torch.train.profile_round import (
        async_apply,
        async_launch,
        async_session,
    )

    kw = MODES["sketch"]
    want, recs, _ = _async(data, {**kw, **ANCHOR}, n=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = async_session(Config(**{**ONE, **kw, "device": "cpu"}),
                             data[1], classification_loss(torch_tinymlp))
    assert (sess.cfg.async_buffer, sess.cfg.async_concurrency,
            sess.cfg.staleness_exponent, sess.cfg.fuse_clients) == (
                4, 2, 0.5, False)
    ids, batch, host_ids = _lines_inputs(sess, data)
    out = async_launch(sess, ids, batch, LR)
    metrics = async_apply(sess, out, host_ids, LR)
    assert float(metrics["loss"]) == _losses(recs)[0]
    _assert_leaves_equal(sess, want)


def test_async_lines_print_five_lines_and_raise_on_failure(data, capsys):
    """``async_lines`` prints the reference's five lines under their
    names with finite positive ms (host ms here: the card's are
    ``chip_smoke.py``'s), and a failure inside raises instead of an
    "unavailable" line."""
    from commefficient_tpu_torch.train.profile_round import (
        async_lines,
        async_session,
    )

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = async_session(Config(**{**ONE, **MODES["sketch"],
                                       "device": "cpu"}),
                             data[1], classification_loss(torch_tinymlp))
    ids, batch, host_ids = _lines_inputs(sess, data)
    ms = async_lines(sess, ids, batch, host_ids, LR, reps=2)
    printed = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] + "]" for ln in printed] == list(ASYNC_LINES)
    assert all(math.isfinite(v) and v > 0 for v in ms.values()), ms
    assert sess.state.step == 2 + 2 * 2 + 1  # warm + timed + two chains

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    sess.async_round_fns = lambda rung=None: (broken, broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        async_lines(sess, ids, batch, host_ids, LR, reps=2)
    assert "unavailable" not in capsys.readouterr().out

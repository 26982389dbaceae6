"""The port's self-healing training (``commefficient_tpu_torch/resilience/``)
against the reference, on the CPU, at TinyMLP size: the reference's own
cases (tests/test_resilience.py), each with its counterpart here.

* ``Config``: the self-healing flags' refusals and values, the registry
  equal to ``RECOVER_POLICIES``, the ``preempt@R`` and counted
  ``nan_client`` grammar; a transient ``nan_client`` suppressed on replay,
  the port's environment against the reference's round by round;
* the pieces: ``recover_policy='none'`` builds nothing, ``PreemptGuard``'s
  signal riders installed and restored, the vault's snapshot and restore
  bit for bit (also of a snapshot taken at another ladder rung), the
  ledger's and the flight ring's rewinds;
* the runner (``run_train_loop``, the reference's ``_RUNNER_BASE``:
  true_topk, threshold, bernoulli 0.25, 9 rounds): the uninterrupted run
  against the reference's from the same initial params (atol 1e-5); a
  ``nan_client@1:rounds=5-5`` run under ``retry`` bit-equal to the
  uninterrupted one in params, deduped scalars, epoch table and history
  rows, at depth 0 and 2; a rollback into a completed epoch; exhaustion;
  ``demote`` on a ``num_cols`` ladder against the reference's run;
  ``skip_clients`` with the ledger through the reference's checker; the
  blacklist across a checkpoint; stale checkpoints discarded; a policy
  that cannot act aborts before the rewind; preemption's forced save and
  bit-exact resume, and cv_train's exit code 75;
* C.1: after the plans of a 10-rung ``num_cols`` ladder are built, a
  switch to every rung builds none.
"""

import importlib.util
import json
import os
import signal
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from commefficient_tpu.fedsim import parse_chaos as ref_parse_chaos
from commefficient_tpu.fedsim.env import FedEnvironment as RefEnvironment
from commefficient_tpu.resilience import (
    available_recover_policies as ref_available,
)
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.control import controller_header
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.fedsim import (
    ChaosEvent,
    FedEnvironment,
    has_preempt,
    parse_chaos,
)
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops.cuda import countsketch as kern
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.resilience import (
    EXIT_PREEMPTED,
    PreemptGuard,
    PreemptShutdown,
    RollbackVault,
    available_recover_policies,
    build_resilience,
)
from commefficient_tpu_torch.telemetry import (
    CommLedger,
    DivergenceError,
    FlightRecorder,
)
from commefficient_tpu_torch.train import cv_train
from commefficient_tpu_torch.train.cv_train import _CvHooks
from commefficient_tpu_torch.train.runner import run_train_loop
from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer
from commefficient_tpu_torch.utils.config import RECOVER_POLICIES, Config
from commefficient_tpu_torch.utils.logging import MetricsWriter
from test_resilience import _RUNNER_BASE, _Rows, _last_value, _scalars
from test_resilience import _run_loop as ref_run_loop
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_round import _write_cifar_pickles

ROOT = Path(__file__).resolve().parents[1]
ONE = {**BASE, "local_batch_size": 8, "num_devices": 1}
TIMES = {"train_time", "val_time"}
# a sketch num_cols ladder held on rung 0 until a demotion
SKETCH_LADDER = dict(mode="sketch", error_type="virtual",
                     virtual_momentum=0.9, k=40, num_rows=3, num_cols=256,
                     control_policy="fixed", control_schedule="0-=0",
                     ladder="num_cols=256,128")
LOCAL_LADDER = dict(mode="local_topk", error_type="local",
                    local_momentum=0.9, virtual_momentum=0.0, k=60,
                    control_policy="fixed", control_schedule="0-=0")


def _checker():
    """The reference's schema checker, loaded by path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", ROOT / "scripts" / "check_telemetry_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _loop(data, tmp_path, tag, table=None, stats=None, **kw):
    """One TinyMLP run through the port's ``run_train_loop`` with
    cv_train's hooks, the reference's ``_run_loop`` twin (9 rounds a
    epoch): (the session, the run dir, the history)."""
    sess = _session(data, **{**_RUNNER_BASE, **kw})
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
            table=table, writer=writer, engine_stats=stats)
    finally:
        writer.close()
    return sess, run_dir, history


def _strip(rows, drop=TIMES):
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def _leaves_equal(a, b):
    for leaf in ("params_vec", "momentum", "error", "client_vel",
                 "client_err", "comp"):
        x, y = getattr(a.state, leaf), getattr(b.state, leaf)
        assert (x is None) == (y is None), leaf
        if x is not None:
            assert torch.equal(x, y), leaf
    assert a.state.step == b.state.step


# -- Config, registry, grammar ------------------------------------------------


def test_recover_policy_registry_matches_config_tuple():
    assert available_recover_policies() == tuple(sorted(RECOVER_POLICIES))
    assert available_recover_policies() == ref_available()


REFUSALS = [
    (dict(recover_policy="bogus"), r"recover_policy"),
    (dict(snapshot_every=0), r"snapshot_every"),
    (dict(max_recoveries=0), r"max_recoveries"),
    (dict(recover_policy="retry", telemetry_level=0), r"telemetry_level"),
    (dict(recover_policy="demote", telemetry_level=1), r"ladder"),
    (dict(recover_policy="demote", telemetry_level=1,
          control_policy="fixed", control_schedule="0-=0", ladder="k=60",
          mode="true_topk", error_type="virtual", k=60,
          topk_method="threshold"), r">= 2"),
    (dict(recover_policy="skip_clients", telemetry_level=1),
     r"fedsim|masking"),
]


@pytest.mark.parametrize("kw,match", REFUSALS)
def test_config_rejects_bad_resilience_knobs_as_the_reference(kw, match):
    with pytest.raises(ValueError, match=match) as port:
        Config(**kw)
    with pytest.raises(ValueError, match=match) as ref:
        RefConfig(**kw)
    # the same refusal in the same words (the port's own idiom after them)
    assert str(port.value)[:60] == str(ref.value)[:60]


@pytest.mark.parametrize("kw", [
    dict(recover_policy="retry", telemetry_level=1, snapshot_every=4,
         max_recoveries=3),
    dict(recover_policy="skip_clients", telemetry_level=1,
         availability="bernoulli", dropout_prob=0.2),
    dict(recover_policy="demote", telemetry_level=1, **LOCAL_LADDER,
         ladder="k=60,30"),
    dict(preempt_signals=True, chaos="preempt@3,nan_client@2:rounds=3-4"),
])
def test_config_accepts_the_resilience_flags_as_the_reference(kw):
    cfg, ref = Config(**kw), RefConfig(**kw)
    for name in ("recover_policy", "snapshot_every", "max_recoveries",
                 "preempt_signals", "recovery_enabled", "fedsim_enabled"):
        assert getattr(cfg, name) == getattr(ref, name), name


def test_chaos_grammar_preempt_and_counted_nan():
    assert parse_chaos("preempt@7") == (ChaosEvent("preempt", 7.0, 7, 7, 1),)
    assert parse_chaos("nan_client@2:rounds=3-4") == (
        ChaosEvent("nan_client", 2.0, 3, 4, 2),)
    for spec in ("preempt@7", "nan_client@2:rounds=3-4", "nan_client@1:"
                 "rounds=5-5,preempt@2"):
        assert [vars(e) for e in parse_chaos(spec)] == [
            vars(e) for e in ref_parse_chaos(spec)]
    assert parse_chaos("nan_client@1:rounds=5-5")[0].active(5)
    assert not parse_chaos("nan_client@1:rounds=5-5")[0].active(6)
    assert has_preempt(parse_chaos("dropout@0.1,preempt@2"))
    assert not has_preempt(parse_chaos("nan_client@2"))


@pytest.mark.parametrize("bad", ["preempt@-1", "preempt@0.5",
                                 "preempt@3:rounds=1-2",
                                 "nan_client@0:rounds=1-2"])
def test_chaos_grammar_rejects(bad):
    with pytest.raises(ValueError, match="chaos"):
        parse_chaos(bad)


def test_transient_nan_suppressed_on_replay_as_the_reference():
    """The injection fires on a round's first execution only; every other
    draw, and so every mask, is the same on replay: the port's
    environment against the reference's, round by round."""
    for kw in (dict(availability="bernoulli", dropout_prob=0.4,
                    chaos="nan_client@2:rounds=3-3"),
               dict(chaos="preempt@3,nan_client@1:rounds=2-5,"
                          "straggler@0.2")):
        kw = dict(num_workers=8, num_clients=16, seed=7, **kw)
        port, ref = FedEnvironment(Config(**kw)), RefEnvironment(
            RefConfig(**kw))
        for r in range(8):
            for replay in (False, True):
                got = port.round_env(r, replay=replay)
                want = ref.round_env(r, replay=replay)
                np.testing.assert_array_equal(got.live, want.live)
                np.testing.assert_array_equal(got.corrupt, want.corrupt)
                assert got.live_count == want.live_count
                assert got.stats == {k: want.stats[k] for k in got.stats}
                assert "fedsim/preempt" in got.stats
    env = FedEnvironment(Config(**kw))
    first, replay = env.round_env(3), env.round_env(3, replay=True)
    assert first.corrupt.sum() == 1 and replay.corrupt.sum() == 0
    np.testing.assert_array_equal(first.live, replay.live)
    assert first.stats["fedsim/preempt"] == 1.0
    assert env.round_env(2).stats["fedsim/preempt"] == 0.0


# -- the pieces ---------------------------------------------------------------


def test_default_config_builds_nothing(data):
    sess = _session(data, mode="uncompressed")
    assert not sess.cfg.recovery_enabled
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    assert build_resilience(sess.cfg, sess, _sampler(data, sess.cfg)) is None
    assert sess.resilience is None
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


def test_preempt_guard_signals_install_and_restore():
    prev = (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT))
    guard = PreemptGuard(install_signals=True)
    assert guard.signals_installed
    assert signal.getsignal(signal.SIGTERM) == guard._on_signal
    guard.close()
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == prev
    g = PreemptGuard()
    assert not g.check_metrics({"fedsim/preempt": 0.0})
    assert g.check_metrics({"fedsim/preempt": 1.0})
    assert g.source == "chaos preempt@round"
    g.request("signal SIGTERM")
    assert g.source == "chaos preempt@round"  # the first source wins
    assert EXIT_PREEMPTED == 75


def _rounds(sess, sampler, start, stop, lr=0.3):
    for r in range(start, stop):
        ids, batch = sampler.sample_round(r)
        sess.train_round(ids, batch, lr)


def test_vault_snapshot_restore_roundtrip_bitwise(data):
    """The vault restores the captured state exactly, and the same rounds
    run again reproduce the first pass: the retry policy's mechanism."""
    sess = _session(data, mode="true_topk", error_type="virtual",
                    virtual_momentum=0.9, k=40)
    sampler = _sampler(data, sess.cfg)
    _rounds(sess, sampler, 0, 3)
    vault = RollbackVault(snapshot_every=3)
    assert vault.will_snapshot(3) and not vault.will_snapshot(2)
    assert not vault.will_snapshot(0)
    snap = vault.snapshot(sess, 3)
    assert snap.nbytes == sum(t.numel() * 4 for t in (
        sess.state.params_vec, sess.state.momentum, sess.state.error))
    at3 = sess.state.params_vec.clone()
    err3 = sess.state.error.clone()
    _rounds(sess, sampler, 3, 5)
    first = sess.state.params_vec.clone()
    assert not torch.equal(at3, first)
    assert vault.latest(max_step=4).step == 3 and vault.latest(2) is None
    assert vault.restore(sess, vault.latest(max_step=4)) == 3
    assert torch.equal(sess.state.params_vec, at3)
    assert torch.equal(sess.state.error, err3)
    assert sess.state.step == 3
    # the restored leaves are copies: the replay leaves the snapshot alone
    _rounds(sess, sampler, 3, 5)
    assert torch.equal(sess.state.params_vec, first)
    assert torch.equal(snap.fed_state["params_vec"], at3)
    # a boundary captured again replaces its entry
    vault.snapshot(sess, 3)
    vault.snapshot(sess, 6)
    vault.snapshot(sess, 6)
    assert [s.step for s in vault._snaps] == [3, 6] and vault.captures == 4


def test_vault_restores_a_snapshot_taken_at_another_rung(data):
    """A snapshot at rung 0 restored after a switch to rung 1: the saved
    rung is activated without a migration and every leaf is the
    snapshot's, in the controller's blob too."""
    from commefficient_tpu_torch.control import build_controller

    sess = _session(data, **SKETCH_LADDER, telemetry_level=1)
    ctrl = build_controller(sess.cfg, sess, num_rounds=9)
    sampler = _sampler(data, sess.cfg)
    _rounds(sess, sampler, 0, 2)
    vault = RollbackVault(snapshot_every=2)
    vault.snapshot(sess, 2)
    want = {f: (t.clone() if torch.is_tensor(t) else t)
            for f, t in vars(sess.state).items()}
    blob = ctrl.state_blob()
    ctrl.demote(2)  # rung 1, its tables re-sketched
    assert sess.active_rung == 1 and ctrl.min_rung == 1
    _rounds(sess, sampler, 2, 4)
    assert sess.state.error.shape == sess.rungs[1].spec.table_shape
    vault.restore(sess, vault.latest())
    assert sess.active_rung == 0
    for f, t in want.items():
        got = getattr(sess.state, f)
        assert torch.equal(got, t) if torch.is_tensor(t) else got == t, f
    restored = ctrl.state_blob()
    assert restored[1] == blob[1] == 0
    assert ctrl.min_rung == 1  # the demotion floor survives the rollback


def test_ledger_snapshot_state_roundtrip():
    bpr = {"upload_floats": 20, "download_floats": 100,
           "upload_bytes": 80, "download_bytes": 400}
    led = CommLedger(bpr, mode="true_topk", num_workers=8)
    for s in range(3):
        led.on_round(s)
    state = led.snapshot_state()
    for s in range(3, 6):
        led.on_round(s)
    assert led.rounds == 6
    led.load_snapshot_state(state)
    assert led.rounds == 3 and led.cum_up_bytes == 3 * 80
    for s in range(3, 6):
        led.on_round(s)
    assert led.cum_up_bytes == 6 * 80


def test_flight_rewind_drops_rolled_back_records():
    fl = FlightRecorder(logdir="", window=8)
    for s in range(6):
        fl.record(s, 0.1, {"loss": 1.0})
    fl.rewind(3)
    assert [r["step"] for r in fl.records] == [0, 1, 2]
    assert fl.last_step == 2
    fl.rewind(0)
    assert not fl.records and fl.last_step is None


# -- the runner ---------------------------------------------------------------


@pytest.fixture(scope="module")
def uninterrupted(data, tmp_path_factory):
    """The port's chaos-free run every recovery twin holds against."""
    tmp = tmp_path_factory.mktemp("port_resil_base")
    rows = _Rows()
    sess, run_dir, history = _loop(data, tmp, "_base", table=rows)
    return dict(sess=sess, scalars=_scalars(run_dir), table=rows.rows,
                history=history, run_dir=run_dir)


def test_uninterrupted_run_matches_the_reference(data, uninterrupted,
                                                 tmp_path):
    """The port's run against the reference's ``_run_loop`` from the same
    initial params, both on one device: params within 1e-5, the same
    fedsim masks and bytes, the losses within 1e-4."""
    ref, ref_dir, _ = ref_run_loop(tmp_path, "_ref", num_devices=1)
    got = uninterrupted["sess"].state.params_vec.numpy()
    np.testing.assert_allclose(got, np.asarray(ref.state.params_vec),
                               rtol=0, atol=1e-5)
    want = {(n, s): v for n, v, s in _scalars(ref_dir)}
    have = {(n, s): v for n, v, s in uninterrupted["scalars"]}
    for (name, step), v in have.items():
        if name.startswith(("fedsim/", "comm/", "lr")):
            assert v == want[(name, step)], (name, step)
        elif name == "train/loss":
            np.testing.assert_allclose(v, want[(name, step)], rtol=1e-4)
    assert sum(n == "train/loss" for n, _ in have) == 9


def test_retry_heals_nan_client_bit_exactly(data, uninterrupted, tmp_path):
    """``nan_client@1:rounds=5-5`` under retry: detected at the round-8
    snapshot's drain, rolled back to the round-4 snapshot, and the healed
    run equals the uninterrupted one bit for bit: every leaf, the deduped
    scalars (the ledger's bytes included: the rollback rewound them), the
    epoch table, and one history row a round."""
    rows = _Rows()
    sess, run_dir, history = _loop(
        data, tmp_path, "_retry", table=rows,
        chaos="nan_client@1:rounds=5-5", recover_policy="retry",
        snapshot_every=4)
    _leaves_equal(sess, uninterrupted["sess"])
    assert _last_value(run_dir, "resilience/recoveries") == 1.0
    assert _last_value(run_dir, "resilience/rollback_round") == 4.0
    assert _scalars(run_dir) == uninterrupted["scalars"]
    assert _strip(rows.rows) == _strip(uninterrupted["table"])
    drop = {"ms", "data_ms"}
    assert [r["step"] for r in history] == list(range(9))
    assert _strip(history, drop) == _strip(uninterrupted["history"], drop)
    _checker().validate_run_dir(run_dir)
    rec = json.loads(Path(run_dir, "flight_5_recovery.json").read_text())
    hist = rec["recovery_history"]
    assert len(hist) == 1 and hist[0]["outcome"] == "recovered"
    assert hist[0]["first_bad_step"] == 5 and hist[0]["rollback_to"] == 4
    assert [r["step"] for r in rec["records"]] == [0, 1, 2, 3]
    assert os.path.exists(os.path.join(run_dir, "flight_5.json"))
    led = json.loads(Path(run_dir, "comm_ledger.json").read_text())
    base = json.loads(Path(uninterrupted["run_dir"],
                           "comm_ledger.json").read_text())
    assert led == base


def test_retry_heals_under_pipelined_engine(data, uninterrupted, tmp_path):
    """At ``--pipeline_depth 2`` the recovery drops the staged window and
    stages again from the rollback round with replay=True: still bit-equal
    to the uninterrupted depth-0 run."""
    stats = {}
    sess, run_dir, history = _loop(
        data, tmp_path, "_retry_p2", stats=stats,
        chaos="nan_client@1:rounds=5-5", recover_policy="retry",
        snapshot_every=4, pipeline_depth=2)
    _leaves_equal(sess, uninterrupted["sess"])
    assert stats["restarts"] == 1
    assert _last_value(run_dir, "resilience/recoveries") == 1.0
    seq = _scalars(run_dir, exclude=("resilience/", "pipeline/", "trace/",
                                     "xla/exposed_collective_ms"))
    assert seq == uninterrupted["scalars"]
    assert [r["step"] for r in history] == list(range(9))


def test_retry_rollback_into_completed_epoch_no_duplicate_rows(data,
                                                               tmp_path):
    """Round 9 opens epoch 1; the round-12 drain detects it and rolls back
    to the round-8 snapshot inside epoch 0, whose end block must not run
    again."""
    base_rows, heal_rows = _Rows(), _Rows()
    base, _, base_hist = _loop(data, tmp_path, "_xepoch_base",
                               table=base_rows, num_epochs=2)
    sess, run_dir, history = _loop(
        data, tmp_path, "_xepoch_heal", table=heal_rows, num_epochs=2,
        chaos="nan_client@1:rounds=9-9", recover_policy="retry",
        snapshot_every=4)
    assert _last_value(run_dir, "resilience/recoveries") == 1.0
    assert _last_value(run_dir, "resilience/rollback_round") == 8.0
    assert len(heal_rows.rows) == 2
    assert _strip(heal_rows.rows) == _strip(base_rows.rows)
    assert [r["step"] for r in history] == list(range(18))
    _leaves_equal(sess, base)


def test_retry_exhaustion_reraises_with_history(data, tmp_path):
    with pytest.raises(DivergenceError) as ei:
        _loop(data, tmp_path, "_exhaust", chaos="nan_client@1:rounds=3-8",
              recover_policy="retry", snapshot_every=2, max_recoveries=2)
    hist = ei.value.recovery_history
    assert len(hist) == 3  # two recoveries and the give-up
    assert [h["outcome"] for h in hist[:2]] == ["recovered", "recovered"]
    assert "exhausted" in hist[-1]["outcome"]


def test_demote_on_a_num_cols_ladder_matches_the_reference(data, tmp_path):
    """``nan_client@3`` under demote on a sketch ``num_cols`` ladder held
    on rung 0: the replay from the round-2 snapshot runs rung 1 (the
    restored tables re-sketched through ``migrate_state``), in both
    packages; the port's end state within the ladder twins' tolerances of
    the reference's."""
    kw = dict(SKETCH_LADDER, chaos="nan_client@3", recover_policy="demote",
              snapshot_every=2)
    sess, run_dir, history = _loop(data, tmp_path, "_demote", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, ref_dir, _ = ref_run_loop(tmp_path, "_demote_ref",
                                       num_devices=1, **kw)
    got, want = _scalars(run_dir, exclude=()), _scalars(ref_dir, exclude=())
    rungs = [(s, v) for n, v, s in got if n == "control/rung"]
    assert rungs == [(s, v) for n, v, s in want if n == "control/rung"]
    assert [v for s, v in rungs if s < 2] == [0.0, 0.0]
    assert all(v == 1.0 for s, v in rungs if s >= 2), rungs
    for name in ("resilience/rung_demotions", "resilience/recoveries",
                 "resilience/rollback_round"):
        assert _last_value(run_dir, name) == _last_value(ref_dir, name) \
            == {"resilience/rollback_round": 2.0}.get(name, 1.0), name
    assert sess.state.step == 9 and sess.active_rung == 1
    assert sess.controller.min_rung == 1
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec), rtol=0,
                               atol=1e-5)
    for leaf in ("momentum", "error"):
        w = np.asarray(getattr(ref.state, leaf))
        g = getattr(sess.state, leaf).numpy()
        assert g.shape == w.shape == sess.rungs[1].spec.table_shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0))
    np.testing.assert_array_equal(sess.controller.state_blob(),
                                  ref.controller.state_blob())
    assert [r["step"] for r in history] == list(range(9))


def test_preloop_failure_restores_signal_dispositions(data, tmp_path,
                                                      monkeypatch):
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))

    def boom(self, session, step=None):
        raise ValueError("restore failed at every retained checkpoint step")

    monkeypatch.setattr(FedCheckpointer, "restore", boom)
    with pytest.raises(ValueError, match="every retained"):
        _loop(data, tmp_path, "_preloop", preempt_signals=True,
              recover_policy="retry", checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every=2, resume=True)
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


def test_repeated_demote_descends_past_stale_snapshot_floor(data, tmp_path):
    """The demotion floor is monotone across rollbacks: with only the
    baseline snapshot to go back to, a second divergence descends to rung
    2, not to the rung 1 that just diverged."""
    sess, run_dir, history = _loop(
        data, tmp_path, "_demote2", **LOCAL_LADDER, ladder="k=60,30,15",
        num_epochs=2,
        chaos="nan_client@1:rounds=2-2,nan_client@1:rounds=11-11",
        recover_policy="demote", snapshot_every=32, max_recoveries=2)
    assert sess.state.step == 18
    assert _last_value(run_dir, "resilience/recoveries") == 2.0
    assert _last_value(run_dir, "resilience/rung_demotions") == 2.0
    assert _last_value(run_dir, "control/rung") == 2.0
    assert sess.controller.min_rung == 2
    assert [r["step"] for r in history] == list(range(18))


def test_skip_clients_blacklists_and_the_ledger_holds(data, tmp_path):
    """The suspect is masked out of every later round, the run completes,
    and the ledger's live-byte invariant holds (the reference's checker,
    and recomputed from the logged rates, the replayed rounds deduped)."""
    sess, run_dir, _ = _loop(
        data, tmp_path, "_skip", mode="uncompressed", error_type="none",
        virtual_momentum=0.9, chaos="nan_client@3",
        recover_policy="skip_clients", snapshot_every=2)
    assert sess.state.step == 9
    bl = sess._client_blacklist
    assert bl is not None and len(bl) >= 1
    assert _last_value(run_dir, "resilience/blacklisted_clients") == len(bl)
    _checker().validate_run_dir(run_dir)
    rates = [json.loads(line) for line in open(
        os.path.join(run_dir, "metrics.jsonl"))
        if '"fedsim/participation_rate"' in line]
    live_sum = round(sum({r["step"]: r["value"]
                          for r in rates}.values()) * 8)
    led = json.loads(Path(run_dir, "comm_ledger.json").read_text())
    assert led["live_client_rounds"] == live_sum
    assert led["cum_up_bytes"] == (led["live_client_rounds"]
                                   * led["bytes_per_round"]["upload_bytes"])
    # from the rollback on no blacklisted client takes part
    sampler = _sampler(data, sess.cfg)
    for r in range(2, 9):
        ids = sampler.sample_round_indices(r)[0]
        env = sess.fedsim_round_env(r, ids)
        assert not np.isin(ids[env.live > 0], bl).any()


def test_skip_clients_blacklist_survives_checkpoint_resume(data, tmp_path):
    kw = dict(_RUNNER_BASE, mode="uncompressed", error_type="none",
              chaos="nan_client@3", recover_policy="skip_clients",
              checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    sess = _session(data, **kw)
    sess.blacklist_clients([3, 7])
    ck = FedCheckpointer(sess.cfg)
    assert ck.maybe_save(sess, 2, force=True)
    sess2 = _session(data, **kw)
    assert sess2._client_blacklist is None
    assert FedCheckpointer(sess2.cfg).restore(sess2) == 0
    np.testing.assert_array_equal(sess2._client_blacklist, [3, 7])
    # a checkpoint without a blacklist keeps the session's
    kw2 = dict(kw, checkpoint_dir=str(tmp_path / "ck2"))
    sess3 = _session(data, **kw2)
    assert FedCheckpointer(sess3.cfg).maybe_save(sess3, 2, force=True)
    sess4 = _session(data, **kw2)
    sess4.blacklist_clients([5])
    assert FedCheckpointer(sess4.cfg).restore(sess4) == 0
    np.testing.assert_array_equal(sess4._client_blacklist, [5])
    # a session that cannot mask refuses to be handed one
    plain = _session(data, **dict(kw, availability="always",
                                  dropout_prob=0.0, chaos="",
                                  recover_policy="none"))
    with pytest.raises(ValueError, match="fedsim"):
        FedCheckpointer(plain.cfg).restore(plain)


def test_recovery_discards_stale_checkpoints_above_rollback(data, tmp_path):
    """Snapshots at 4 and 8, a checkpoint at 5, a nan at 6 detected at the
    round-8 drain: the rollback to 4 drops step 5 (saved from the
    rolled-back trajectory, before the demotion), so the replay saves its
    own, with the demoted rung and the floor in the blob."""
    ck_dir = tmp_path / "ck"
    _loop(data, tmp_path, "_stale", **LOCAL_LADDER, ladder="k=60,30",
          chaos="nan_client@6", recover_policy="demote", snapshot_every=4,
          checkpoint_dir=str(ck_dir), checkpoint_every=5)
    run_dir = str(tmp_path / "run_stale")
    assert _last_value(run_dir, "resilience/recoveries") == 1.0
    assert _last_value(run_dir, "resilience/rollback_round") == 4.0
    blob = torch.load(ck_dir / "step_5.pt", weights_only=True)["control"]
    assert blob[1] == 1.0 and blob[7] == 1.0
    # the fork was saved at the rollback round too, and every step on disk
    # has its manifest
    assert torch.load(ck_dir / "step_4.pt",
                      weights_only=True)["control"][7] == 1.0
    ck = FedCheckpointer(Config(checkpoint_dir=str(ck_dir)))
    assert ck.all_steps() == [4, 5, 9]
    assert all(ck.verify_step(s) is None for s in ck.all_steps())
    assert sorted(os.listdir(ck_dir / "manifests")) == [
        "4.json", "5.json", "9.json"]


def test_unavailable_policy_aborts_before_rewind(data, tmp_path):
    """A second demotion on a floored 2-rung ladder cannot act: the
    recovery gives up BEFORE the rewind, so the dead run's ledger bills
    the rounds that ran (0, 1, the replayed 2-5 and the bad 6)."""
    with pytest.raises(DivergenceError) as ei:
        _loop(data, tmp_path, "_unavail", **LOCAL_LADDER, ladder="k=60,30",
              chaos="nan_client@3,nan_client@6", recover_policy="demote",
              snapshot_every=2)
    hist = ei.value.recovery_history
    assert [h["outcome"][:10] for h in hist] == ["recovered", "policy una"]
    assert "cheapest rung" in hist[-1]["outcome"]
    led = json.loads(Path(tmp_path, "run_unavail",
                          "comm_ledger.json").read_text())
    assert led["rounds"] == 7


def test_preempt_shutdown_message_honest_without_checkpointing():
    e = PreemptShutdown(4, "signal SIGTERM", saved=False)
    assert not e.saved
    assert "NO checkpoint was saved" in str(e)
    assert "--resume to continue bit-exactly" not in str(e)
    assert str(EXIT_PREEMPTED) in str(e)
    assert PreemptShutdown(4, "x").saved


def test_preempt_chaos_forced_checkpoint_and_resume(data, uninterrupted,
                                                    tmp_path):
    """``preempt@3``: rounds 0-3 run, the metrics drain, a checkpoint is
    forced at 4 and ``PreemptShutdown`` carries its promise; the resumed
    run equals the uninterrupted one bit for bit."""
    ck = str(tmp_path / "ckpt_pre")
    with pytest.raises(PreemptShutdown) as ei:
        _loop(data, tmp_path, "_pre", chaos="preempt@3", checkpoint_dir=ck,
              checkpoint_every=100)
    assert ei.value.step == 4 and ei.value.saved
    assert ei.value.source == "chaos preempt@round"
    assert FedCheckpointer(Config(checkpoint_dir=ck)).latest_step() == 4
    run_pre = str(tmp_path / "run_pre")
    assert _last_value(run_pre, "resilience/preempt_requested") == 1.0
    assert _last_value(run_pre, "train/loss") is not None
    flights = [f for f in os.listdir(run_pre) if f.startswith("flight_")]
    rec = json.loads(Path(run_pre, flights[0]).read_text())
    assert "preemption requested" in rec["reason"]
    sess, _, history = _loop(data, tmp_path, "_pre_resume",
                             chaos="preempt@3", checkpoint_dir=ck,
                             checkpoint_every=100, resume=True)
    _leaves_equal(sess, uninterrupted["sess"])
    assert [r["step"] for r in history] == list(range(4, 9))


def test_cv_train_preempt_exits_75(tmp_path, capsys):
    """cv_train turns the shutdown into ``SystemExit(75)``; the rider's
    line is printed."""
    _write_cifar_pickles(str(tmp_path))
    with pytest.raises(SystemExit) as ei:
        cv_train.main(["--mode", "uncompressed", "--num_clients", "4",
                       "--num_workers", "2", "--local_batch_size", "4",
                       "--num_epochs", "1", "--compute_dtype", "float32",
                       "--chaos", "preempt@1", "--dataset_dir",
                       str(tmp_path), "--logdir", str(tmp_path / "runs"),
                       "--checkpoint_dir", str(tmp_path / "ck"),
                       "--device", "cpu"],
                      eval_batch_size=8, model_kw={"width": 4})
    assert ei.value.code == EXIT_PREEMPTED
    assert isinstance(ei.value.__cause__, PreemptShutdown)
    assert ei.value.__cause__.saved and ei.value.__cause__.step == 2
    out = capsys.readouterr().out
    assert "resilience: preempt_guard=chaos" in out
    assert "exit code 75" in out


@pytest.mark.slow  # two cv_train runs of a few rounds at ResNet-9 width 8
def test_cv_train_retry_heals_e2e(tmp_path):
    """The entry point's twin of the runner tests: cv_train with
    ``nan_client@1:rounds=5-5`` under retry ends bit-equal to the clean
    run."""
    _write_cifar_pickles(str(tmp_path), n_per_batch=32)

    def run(tag, *extra):
        return cv_train.main(
            ["--mode", "sketch", "--k", "200", "--num_rows", "3",
             "--num_cols", "4000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--num_clients", "8",
             "--num_workers", "4", "--local_batch_size", "4",
             "--num_epochs", "1", "--compute_dtype", "float32",
             "--telemetry_level", "1", "--availability", "bernoulli",
             "--dropout_prob", "0.25", "--dataset_dir", str(tmp_path),
             "--logdir", str(tmp_path / f"runs{tag}"), "--checkpoint_dir",
             str(tmp_path / f"ck{tag}"), "--device", "cpu", *extra],
            eval_batch_size=8, model_kw={"width": 8})

    clean = run("_clean")
    healed = run("_chaos", "--chaos", "nan_client@1:rounds=5-5",
                 "--recover_policy", "retry", "--snapshot_every", "4")
    steps = clean["final_step"]
    assert healed["final_step"] == steps
    a, b = (torch.load(tmp_path / f"ck{t}" / f"step_{steps}.pt",
                       weights_only=True)["fed_state"]
            for t in ("_clean", "_chaos"))
    assert all(torch.equal(a[k], b[k]) for k in a if torch.is_tensor(a[k]))
    assert _last_value(healed["logdir"], "resilience/recoveries") == 1.0


# -- C.1: no plan built on a switch after the prewarm -------------------------


def test_prewarmed_ten_rung_ladder_switches_build_no_plan(data):
    """The per-spec plan caches keep every rung of a 10-rung ``num_cols``
    ladder once built (they held 8 and evicted the first rungs): after
    ``prepare_plans`` of every rung, a switch to each rung and the plans
    its kernels read cost no build. The plans are host work, built here on
    the CPU; the card's twin is in tests/test_torch_cuda_kernels.py."""
    from commefficient_tpu_torch.control import build_controller

    cols = ",".join(str(c) for c in range(256, 16, -24))
    sess = _session(data, mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=40, num_rows=3, num_cols=256,
                    control_policy="fixed", control_schedule="0-=0",
                    ladder=f"num_cols={cols}")
    build_controller(sess.cfg, sess, num_rounds=9)
    assert len(sess.rungs) == 10
    specs = [r.spec for r in sess.rungs]
    assert len({s.table_shape for s in specs}) == 10
    for spec in specs:
        kern.prepare_plans(spec, "cpu")
    built = kern.plan_builds()
    for i in [*range(1, 10), 0]:
        sess.set_active_rung(i)
        kern.prepare_plans(sess.spec, "cpu")
        kern._kernel_geometry(sess.spec, "cpu")
        kern._k2_plan(sess.spec, "cpu", 4)
    assert kern.plan_builds() == built
    assert sess.active_rung == 0


def test_end_of_training_checkpoint_and_resume_after_completion(
        data, uninterrupted, tmp_path):
    """A finished run force-saves its final round (9, an odd tail), and a
    resume of it trains nothing: the state is the unbroken run's, no
    round is logged and the step on disk is not saved again."""
    ck = str(tmp_path / "ck")
    sess, _, history = _loop(data, tmp_path, "_full", checkpoint_dir=ck,
                             checkpoint_every=2)
    assert len(history) == 9
    assert FedCheckpointer(Config(checkpoint_dir=ck)).all_steps() == [6, 8,
                                                                       9]
    mtime = os.path.getmtime(os.path.join(ck, "step_9.pt"))
    again, run_dir, history = _loop(data, tmp_path, "_after",
                                    checkpoint_dir=ck, checkpoint_every=2,
                                    resume=True)
    assert history == [] and again.state.step == 9
    _leaves_equal(again, uninterrupted["sess"])
    assert not [r for r in _scalars(run_dir) if r[0] == "train/loss"]
    assert os.path.getmtime(os.path.join(ck, "step_9.pt")) == mtime


def test_restore_exhausting_all_steps_chains_failures(data, tmp_path):
    """Every retained step's manifest tampered: restore warns step by step
    and the error names each step with its reason."""
    ck = str(tmp_path / "ck")
    sess = _session(data, **_RUNNER_BASE, checkpoint_dir=ck)
    checkpointer = FedCheckpointer(sess.cfg)
    for step in (2, 4):
        assert checkpointer.maybe_save(sess, step, force=True)
    for step in (2, 4):
        path = os.path.join(ck, "manifests", f"{step}.json")
        man = json.loads(Path(path).read_text())
        man["sha256"] = "0" * 64
        Path(path).write_text(json.dumps(man))
    with pytest.warns(UserWarning, match="REJECTED"):
        with pytest.raises(ValueError, match="every retained") as ei:
            checkpointer.restore(_session(data, **_RUNNER_BASE,
                                          checkpoint_dir=ck))
    for step in (2, 4):
        assert f"step {step}: sha256 mismatch" in str(ei.value)

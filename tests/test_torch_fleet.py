"""The port's elastic fleet (per-width rounds, ``resize``/``leave``/
``join``/``shrink``) against the reference, on the CPU, at TinyMLP size:
the reference's own cases (tests/test_fleet.py), each with its
counterpart here, the reference's sessions at one device.

* the schedule (``fleet_width_at``, ``fleet_transitions``,
  ``fleet_widths``, ``fleet_shrink_at``) and ``FedEnvironment``'s
  ``width_at``, ``fleet_stats`` and width-``w`` masks equal to the
  reference's; ``Config``'s acceptance and refusals in the reference's
  words;
* the session: a fleet-less config builds nothing; a round dispatched at
  width 4 bit-equal to a session provisioned at 4, and within the twins'
  tolerance of the reference's; an 8 -> 4 -> 8 session against the
  reference's (losses, params, ``fleet/*``); ``FleetShrinkError`` on the
  first execution and a quiet replay;
* the runner (``run_train_loop``, the reference's ``_RUNNER_BASE``): the
  resize and shrink twins against the reference's ``metrics.jsonl`` and
  ``comm_ledger.json``, the shrink heal bit-equal to the resize twin, a
  preemption inside the resize window resumed bit-exactly, every run dir
  through the reference's schema checker; no reference ``xla/retraces``
  value is pinned (the port compiles no round: ``kern.plan_builds()`` is
  its counterpart);
* the riders: the ledger's billing at the realized width, the
  controller's blob[8] and a rung switch inside a resize window against
  the reference's; a hosted client store bit-equal to the device bank;
  two gloo ranks against one process.
"""

import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.fedsim import parse_chaos as ref_parse_chaos
from commefficient_tpu.fedsim import faults as ref_faults
from commefficient_tpu.fedsim.env import FedEnvironment as RefEnvironment
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.telemetry import CommLedger as RefLedger
from commefficient_tpu.utils.config import Config as RefConfig
import commefficient_tpu.control as ref_control
from commefficient_tpu_torch.control import build_controller, controller_header
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.fedsim import (
    FedEnvironment,
    fleet_shrink_at,
    fleet_transitions,
    fleet_width_at,
    fleet_widths,
    has_fleet,
    parse_chaos,
    validate_chaos_rounds,
)
from commefficient_tpu_torch.fedsim import faults as port_faults
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops.cuda import countsketch as kern
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.resilience import PreemptShutdown
from commefficient_tpu_torch.telemetry import (
    CommLedger,
    DivergenceError,
    FleetShrinkError,
)
from commefficient_tpu_torch.train.cv_train import _CvHooks
from commefficient_tpu_torch.train.runner import run_train_loop
from commefficient_tpu_torch.utils.config import Config
from commefficient_tpu_torch.utils.logging import MetricsWriter
from test_fleet import _FLEET_KW, _RUNNER_BASE, _scalars, _series
from test_fleet import _run_loop as ref_run_loop
from test_round import BASE, _setup
from test_torch_gloo_worker import spawn
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_sparse_aggregate import _without_vma_check

ROOT = Path(__file__).resolve().parents[1]
ONE = {**BASE, "num_devices": 1}
LR = 0.3
# the reference's schedule cases (tests/test_fleet.py)
PLANS = ["resize@4:rounds=3-5", "leave@4:rounds=2-,join@2:rounds=6-",
         "shrink@4:rounds=5-", "resize@4:rounds=0-",
         "resize@6:rounds=1-3,leave@2:rounds=2-,join@2:rounds=5-6"]
# the session twins' mode: the reference's own fleet session case
TOPK = dict(mode="true_topk", error_type="virtual", virtual_momentum=0.9,
            k=40, topk_method="threshold", telemetry_level=1)
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=40, num_rows=3, num_cols=256)
# the runner twins: the reference's _RUNNER_BASE at one device
RUNNER = {**_RUNNER_BASE, "num_devices": 1}


def _checker():
    """The reference's schema checker, loaded by path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", ROOT / "scripts" / "check_telemetry_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    """(the reference's dataset, its initial params, its loss, the
    reference sampler's first 8 draws at W = 8, B = 4)."""
    ds, params, loss_ref = _setup(BASE["num_clients"])
    sampler = RefSampler(ds, num_workers=8, local_batch_size=4, seed=1)
    draws = [sampler.sample_round(r) for r in range(8)]
    return ds, params, loss_ref, draws


def _port(data, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return FederatedSession(Config(**{**ONE, **kw, "device": "cpu"}),
                                to_numpy_tree(data[1]),
                                classification_loss(torch_tinymlp))


def _ref(data, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return RefSession(RefConfig(**{**ONE, **kw}), data[1], data[2])


def _ref_rounds(sess, draws, lr=LR):
    """The reference's rounds, ``shard_map``'s replication check off (jax
    0.9.0 refuses some of the reference's rounds with it on: the values
    are right)."""
    import commefficient_tpu.parallel.round as ref_round

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_round, "shard_map",
                   _without_vma_check(ref_round.shard_map))
        for ids, batch in draws:
            m = sess.train_round(ids, batch, lr)
            out.append({k: float(v) for k, v in m.items()})
    return out


def _port_rounds(sess, draws, lr=LR):
    return [{k: float(v) for k, v in sess.train_round(ids, batch, lr).items()}
            for ids, batch in draws]


# -- the schedule, the environment, Config ------------------------------------


@pytest.mark.parametrize("spec", PLANS)
def test_schedule_matches_the_reference(spec):
    plan, ref = parse_chaos(spec), ref_parse_chaos(spec)
    assert [fleet_width_at(plan, 8, r) for r in range(12)] == [
        ref_faults.fleet_width_at(ref, 8, r) for r in range(12)]
    assert fleet_transitions(plan, 8) == ref_faults.fleet_transitions(ref, 8)
    assert fleet_widths(plan, 8) == ref_faults.fleet_widths(ref, 8)
    assert port_faults.fleet_boundaries(plan) == ref_faults.fleet_boundaries(
        ref)
    assert [fleet_shrink_at(plan, r) for r in range(12)] == [
        ref_faults.fleet_shrink_at(ref, r) for r in range(12)]
    assert [vars(e) for e in port_faults.fleet_plan(plan)] == [
        vars(e) for e in ref_faults.fleet_plan(ref)]
    assert has_fleet(plan) and ref_faults.has_fleet(ref)


def test_schedule_folds_as_the_reference_pins():
    plan = parse_chaos("resize@4:rounds=3-5")
    assert [fleet_width_at(plan, 8, r) for r in range(7)] == [
        8, 8, 8, 4, 4, 4, 8]
    assert fleet_transitions(plan, 8) == ((3, 4), (6, 8))
    assert fleet_widths(plan, 8) == (8, 4)
    plan = parse_chaos("leave@4:rounds=2-,join@2:rounds=6-")
    assert [fleet_width_at(plan, 8, r) for r in (0, 2, 5, 6, 9)] == [
        8, 4, 4, 6, 6]
    assert fleet_widths(plan, 8) == (8, 4, 6)
    plan = parse_chaos("shrink@4:rounds=5-")
    assert fleet_shrink_at(plan, 5) == 4 and fleet_shrink_at(plan, 6) is None
    assert not has_fleet(parse_chaos("dropout@0.2,preempt@3"))
    validate_chaos_rounds(parse_chaos("resize@4:rounds=3-"), 9)
    with pytest.raises(ValueError, match="only 9 rounds"):
        validate_chaos_rounds(parse_chaos("resize@4:rounds=12-"), 9)


@pytest.mark.parametrize("bad", ["resize@0:rounds=3-", "resize@2.5:rounds=3-",
                                 "join@0"])
def test_grammar_rejects_non_positive_widths_as_the_reference(bad):
    with pytest.raises(ValueError, match="positive integer worker count") \
            as port:
        parse_chaos(bad)
    with pytest.raises(ValueError) as ref:
        ref_parse_chaos(bad)
    assert str(port.value).split(". Grammar")[0] == str(ref.value).split(
        ". Grammar")[0]


@pytest.mark.parametrize("spec", PLANS[:3])
def test_environment_matches_the_reference(spec):
    """``width_at``, ``fleet_stats``, the transitions and each round's
    masks at its width (and at an explicit ``width``) under bernoulli
    participation, round by round and on replay."""
    kw = dict(num_workers=8, num_clients=16, seed=7, availability="bernoulli",
              dropout_prob=0.3, chaos=spec)
    if spec.startswith("shrink"):
        kw.update(recover_policy="retry", telemetry_level=1)
    port, ref = FedEnvironment(Config(**kw)), RefEnvironment(RefConfig(**kw))
    assert port.has_fleet and ref.has_fleet
    assert port.widths() == ref.widths()
    assert port.transitions == ref.transitions
    for r in range(10):
        assert port.width_at(r) == ref.width_at(r)
        assert port.shrink_at(r) == ref.shrink_at(r)
        assert port.fleet_stats(r) == ref.fleet_stats(r)
        for width, replay in ((None, False), (None, True), (8, False)):
            got = port.round_env(r, replay=replay, width=width)
            want = ref.round_env(r, replay=replay, width=width)
            np.testing.assert_array_equal(got.live, want.live)
            np.testing.assert_array_equal(got.corrupt, want.corrupt)
            assert got.live_count == want.live_count
            assert got.stats == {k: want.stats[k] for k in got.stats}
            assert set(got.stats) == set(want.stats)
        assert port.round_env(r).live.shape == (port.width_at(r),)


def test_environment_stats_pin_the_reference_values():
    env = FedEnvironment(Config(**_FLEET_KW, chaos="resize@4:rounds=3-5"))
    for r, (w, n, last) in enumerate([(8, 0, -1), (8, 0, -1), (8, 0, -1),
                                      (4, 1, 3), (4, 1, 3), (4, 1, 3),
                                      (8, 2, 6)]):
        assert env.fleet_stats(r) == {
            "fleet/width": float(w), "fleet/resizes": float(n),
            "fleet/last_resize_round": float(last)}, r
    assert env.round_env(3).stats["fleet/width"] == 4.0
    env0 = FedEnvironment(Config(**_FLEET_KW, chaos="dropout@0.2"))
    assert not env0.has_fleet and env0.fleet_stats(0) == {}
    assert env0.width_at(5) == 8 and env0.widths() == (8,)
    assert "fleet/width" not in env0.round_env(2).stats


# the reference's bad plans (tests/test_fleet.py), each refused in its words
REFUSALS = [
    dict(chaos="resize@6:rounds=3-"),
    dict(chaos="join@4:rounds=3-"),
    dict(chaos="leave@8:rounds=3-"),
    dict(chaos="resize@4:rounds=3-", async_buffer=4, async_concurrency=2),
    dict(chaos="resize@4:rounds=3-", pipeline_depth=2),
    dict(chaos="resize@4:rounds=3-", fsdp=True),
    dict(chaos="shrink@4:rounds=5-"),
    dict(chaos="shrink@4:rounds=0-", recover_policy="retry",
         telemetry_level=1),
    dict(chaos="shrink@8:rounds=5-", recover_policy="retry",
         telemetry_level=1),
]


@pytest.mark.parametrize("kw", REFUSALS)
def test_config_refuses_bad_fleet_plans_as_the_reference(kw):
    with pytest.raises(ValueError) as port:
        Config(**{**_FLEET_KW, **kw})
    with pytest.raises(ValueError) as ref:
        RefConfig(**{**_FLEET_KW, **kw})
    assert str(port.value) == str(ref.value)


def test_config_keeps_scan_rounds_refused_with_the_fleet():
    """The reference refuses ``scan_rounds`` with fleet events, and so
    does the port (a captured block holds one width)."""
    with pytest.raises(ValueError, match="scan_rounds"):
        Config(**_FLEET_KW, chaos="resize@4:rounds=3-", scan_rounds=2)
    with pytest.raises(ValueError, match="scan_rounds"):
        RefConfig(**_FLEET_KW, chaos="resize@4:rounds=3-", scan_rounds=2)


@pytest.mark.parametrize("kw", [
    dict(chaos="resize@4:rounds=3-5"),
    dict(chaos="leave@4:rounds=2-,join@4:rounds=6-"),
    dict(chaos="shrink@4:rounds=5-", recover_policy="retry",
         telemetry_level=1),
    dict(chaos="dropout@0.3,resize@4"),
    dict(chaos="dropout@0.3"),
    dict(),
])
def test_config_accepts_fleet_plans_as_the_reference(kw):
    cfg, ref = Config(**_FLEET_KW, **kw), RefConfig(**_FLEET_KW, **kw)
    for name in ("fleet_enabled", "fedsim_enabled", "recovery_enabled"):
        assert getattr(cfg, name) == getattr(ref, name), name


# -- the session ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(chaos="dropout@0.3:rounds=2-4",
                                             telemetry_level=1)],
                         ids=["plain", "other_chaos"])
def test_fleet_disabled_builds_nothing(data, kw):
    """No fleet event, even with other chaos: no width closure, the base
    width, no switch time, each round through the rung's own closure and
    no ``fleet/*`` key."""
    sess = _port(data, mode="uncompressed", **kw)
    assert not sess.cfg.fleet_enabled
    assert all(not r.width_fns for r in sess.rungs)
    assert sess._fleet_width == sess.cfg.num_workers
    for m in _port_rounds(sess, data[3][:3]):
        assert not any(k.startswith("fleet/") for k in m)
        assert sess.round_fn is sess.rungs[0].round_fn
    assert sess._fleet_resize_ms == 0.0 and sess._fleet_width == 8


@pytest.mark.parametrize("kw", [dict(mode="uncompressed"), SKETCH],
                         ids=["uncompressed", "sketch"])
def test_width_parity_against_a_session_provisioned_at_4(data, kw):
    """A round dispatched at width 4 through the fleet (``resize@4:rounds=
    0-``) is bit-equal to a round of a session provisioned at
    ``num_workers 4`` (fedsim on through ``dropout@0.0``): the same loss
    and params; and the port's width-4 round against the reference's
    (loss ``rtol 1e-5``, params ``atol 1e-6``)."""
    ids, batch = data[3][0]
    sess8 = _port(data, **kw, chaos="resize@4:rounds=0-")
    sess4 = _port(data, **kw, num_workers=4, chaos="dropout@0.0:rounds=0-0")
    m8 = sess8.train_round(ids, batch, LR)
    m4 = sess4.train_round(np.asarray(ids)[:4],
                           {k: v[:4] for k, v in batch.items()}, LR)
    assert float(m8["loss"]) == float(m4["loss"])
    assert m8["fleet/width"] == 4.0 and m8["fedsim/participation_rate"] == 1.0
    assert torch.equal(sess8.state.params_vec, sess4.state.params_vec)
    for leaf in ("momentum", "error"):
        a, b = getattr(sess8.state, leaf), getattr(sess4.state, leaf)
        assert (a is None and b is None) or torch.equal(a, b), leaf
    ref = _ref(data, **kw, chaos="resize@4:rounds=0-")
    want = _ref_rounds(ref, data[3][:1])[0]
    np.testing.assert_allclose(float(m8["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(sess8.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec), rtol=0,
                               atol=1e-6)


def test_session_resize_8_4_8_matches_the_reference(data):
    """8 -> 4 -> 8 over 8 rounds: ``fleet/*`` equal to the reference's
    every round, the losses ``rtol 1e-4``, the params ``atol 1e-5``; a
    width closure a rung, a lookup a transition (its ms counted), the
    prewarm building nothing more."""
    kw = dict(TOPK, chaos="resize@4:rounds=3-5")
    sess = _port(data, **kw)
    assert sess.fedsim_env.widths() == (8, 4)
    assert all(set(r.width_fns) == {4} for r in sess.rungs)
    assert sess.prewarm_rungs() == 1
    got = _port_rounds(sess, data[3])
    want = _ref_rounds(_ref(data, **kw), data[3])
    for r, (g, w) in enumerate(zip(got, want)):
        for k in ("fleet/width", "fleet/resizes", "fleet/last_resize_round",
                  "fleet/shrink_recoveries", "fedsim/participation_rate",
                  "fedsim/dropped"):
            assert g[k] == w[k], (r, k)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
    assert [g["fleet/width"] for g in got] == [8, 8, 8, 4, 4, 4, 8, 8]
    assert got[-1]["fleet/resizes"] == 2.0
    assert got[-1]["fleet/last_resize_round"] == 6.0
    ref = _ref(data, **kw)
    _ref_rounds(ref, data[3])
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec), rtol=0,
                               atol=1e-5)
    assert sess._fleet_resize_ms > 0.0
    assert sess.round_fn is sess.rungs[0].round_fn  # back at the base


def test_shrink_raises_fleet_shrink_error_then_replays_quietly(data):
    """A shrink window's first execution raises ``FleetShrinkError`` (a
    ``DivergenceError``) with the step and both widths, before anything of
    the round ran; the replay of the round runs at the shrunk width."""
    kw = dict(TOPK, recover_policy="retry", chaos="shrink@4:rounds=2-")
    sess = _port(data, **kw)
    _port_rounds(sess, data[3][:2])
    before = sess.state.params_vec.clone()
    ids, batch = data[3][2]
    with pytest.raises(DivergenceError) as ei:
        sess.train_round(ids, batch, LR)
    exc = ei.value
    assert isinstance(exc, FleetShrinkError)
    assert exc.step == 2 and exc.fleet_width == 4 and exc.prev_width == 8
    assert exc.reason == "fleet shrank 8 -> 4 workers at round 2"
    assert sess.state.step == 2 and torch.equal(sess.state.params_vec, before)
    m = sess.train_round(ids, batch, LR)
    assert m["fleet/width"] == 4.0 and sess.state.step == 3
    # the reference raises the same error at the same round
    ref = _ref(data, **kw)
    _ref_rounds(ref, data[3][:2])
    from commefficient_tpu.telemetry.flight import (
        FleetShrinkError as RefShrink,
    )

    with pytest.raises(RefShrink) as ri:
        _ref_rounds(ref, data[3][2:3])
    assert str(ri.value) == str(exc)


# -- the runner -------------------------------------------------------------------


def _loop(data, tmp_path, tag, ckpt=None, **kw):
    """One TinyMLP run through the port's ``run_train_loop`` with
    cv_train's hooks: the reference's ``_run_loop`` twin (9 rounds an
    epoch). Returns (the session, the run dir)."""
    ds = data[0]
    cfg = Config(**{**ONE, "local_batch_size": 8, **RUNNER, **(ckpt or {}),
                    **kw, "device": "cpu"})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, to_numpy_tree(data[1]),
                                classification_loss(torch_tinymlp))
    sampler = FedSampler(FedDataset(ds.data, cfg.num_clients, iid=True,
                                    seed=0), num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size, seed=1)
    test_ds = FedDataset({"x": ds.data["x"][:40], "y": ds.data["y"][:40]},
                         1, seed=0)
    run_dir = str(tmp_path / f"run{tag}")
    writer = MetricsWriter(run_dir, cfg=cfg,
                           extra_header=controller_header(sess))
    try:
        run_train_loop(cfg, sess, sampler, _CvHooks(sess, test_ds, 32),
                       writer=writer)
    finally:
        writer.close()
    return sess, run_dir


def _ledger(run_dir):
    return json.loads(Path(run_dir, "comm_ledger.json").read_text())


LEDGER_KEYS = ("rounds", "cum_up_bytes", "cum_down_bytes",
               "live_client_rounds", "avail_client_rounds",
               "bytes_per_round")


def _assert_runner_twin(run_dir, ref_dir):
    """The port's run dir against the reference's: every ``fleet/*``,
    ``fedsim/*``, ``comm/*`` and ``lr`` scalar equal, ``train/loss``
    ``rtol 1e-4``, the ledger's counts equal."""
    want = {(n, s): v for n, v, s in _scalars(ref_dir, exclude=())}
    have = {(n, s): v for n, v, s in _scalars(run_dir, exclude=())}
    compared = 0
    for (name, step), v in have.items():
        if name.startswith(("fleet/", "fedsim/", "comm/", "lr")):
            assert v == want[(name, step)], (name, step)
            compared += 1
        elif name == "train/loss":
            np.testing.assert_allclose(v, want[(name, step)], rtol=1e-4)
    assert compared > 9 * 4
    got, ref = _ledger(run_dir), _ledger(ref_dir)
    for key in LEDGER_KEYS:
        assert got[key] == ref[key], key


@pytest.fixture(scope="module")
def resize_runs(data, tmp_path_factory):
    """The port's ``resize@4:rounds=5-`` run (the shrink heal's twin) and
    its ``resize@4:rounds=3-5`` run."""
    tmp = tmp_path_factory.mktemp("port_fleet_runs")
    return {spec: _loop(data, tmp, f"_{i}", chaos=spec)
            for i, spec in enumerate(("resize@4:rounds=5-",
                                      "resize@4:rounds=3-5"))}


def test_runner_resize_matches_the_reference(data, resize_runs, tmp_path):
    """The scheduled resize through ``run_train_loop``: the width walks 8
    -> 4 -> 8 on schedule, the run dir validates under the reference's
    checker (schema 13), the ledger bills each round at its realized
    width, and the whole run equals the reference's."""
    sess, run_dir = resize_runs["resize@4:rounds=3-5"]
    assert _series(run_dir, "fleet/width") == [
        8.0, 8.0, 8.0, 4.0, 4.0, 4.0, 8.0, 8.0, 8.0]
    assert _series(run_dir, "fleet/resizes")[-1] == 2.0
    assert set(_series(run_dir, "fleet/shrink_recoveries")) == {0.0}
    _checker().validate_run_dir(run_dir)
    assert _ledger(run_dir)["live_client_rounds"] == 6 * 8 + 3 * 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, ref_dir, _ = ref_run_loop(tmp_path, "_ref",
                                       chaos="resize@4:rounds=3-5",
                                       num_devices=1)
    _assert_runner_twin(run_dir, ref_dir)
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec), rtol=0,
                               atol=1e-5)


def test_runner_shrink_heal_bit_equal_to_resize_twin(data, resize_runs,
                                                     tmp_path):
    """An unscheduled ``shrink@4:rounds=5-`` healed under ``retry`` equals
    the scheduled ``resize@4:rounds=5-`` twin bit for bit: the params, the
    deduped scalars and the ledger (the rollback rewound it); one recovery,
    whose history names width 4; and against the reference's healed run."""
    twin, twin_dir = resize_runs["resize@4:rounds=5-"]
    sess, run_dir = _loop(data, tmp_path, "_shrink",
                          chaos="shrink@4:rounds=5-", recover_policy="retry",
                          snapshot_every=4)
    assert torch.equal(sess.state.params_vec, twin.state.params_vec)
    assert sorted(_scalars(run_dir)) == sorted(_scalars(twin_dir))
    assert _series(run_dir, "resilience/recoveries")[-1] == 1.0
    assert _series(run_dir, "fleet/shrink_recoveries")[-1] == 1.0
    assert sess._fleet_shrink_recoveries == 1
    assert _ledger(run_dir) == _ledger(twin_dir)
    assert _ledger(run_dir)["live_client_rounds"] == 5 * 8 + 4 * 4
    _checker().validate_run_dir(run_dir)
    hist = json.loads(Path(run_dir, "flight_5_recovery.json").read_text())[
        "recovery_history"]
    assert len(hist) == 1 and hist[0]["outcome"] == "recovered"
    assert hist[0]["fleet_width"] == 4 and hist[0]["rollback_to"] == 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, ref_dir, _ = ref_run_loop(
            tmp_path, "_ref_shrink", chaos="shrink@4:rounds=5-",
            recover_policy="retry", snapshot_every=4, num_devices=1)
    _assert_runner_twin(run_dir, ref_dir)
    ref_hist = json.loads(Path(ref_dir, "flight_5_recovery.json").read_text(
    ))["recovery_history"]
    assert [{k: h[k] for k in ("outcome", "fleet_width", "rollback_to",
                               "first_bad_step")} for h in hist] == [
        {k: h[k] for k in ("outcome", "fleet_width", "rollback_to",
                           "first_bad_step")} for h in ref_hist]


def test_preempt_inside_resize_window_resumes_bit_exactly(data, resize_runs,
                                                          tmp_path):
    """``preempt@4`` inside ``resize@4:rounds=3-5``: the forced save at
    round 5, and ``--resume`` re-enters at width 4 (from the schedule),
    grows back to 8 and equals the uninterrupted run bit for bit."""
    base, _ = resize_runs["resize@4:rounds=3-5"]
    ckpt = dict(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=100)
    spec = "resize@4:rounds=3-5,preempt@4"
    with pytest.raises(PreemptShutdown) as ei:
        _loop(data, tmp_path, "_pre", ckpt=ckpt, chaos=spec)
    assert ei.value.step == 5 and ei.value.saved
    sess, run_dir = _loop(data, tmp_path, "_res", ckpt=ckpt, chaos=spec,
                          resume=True)
    assert _series(run_dir, "fleet/width") == [4.0, 8.0, 8.0, 8.0]
    assert sess._fleet_width == 8
    assert torch.equal(sess.state.params_vec, base.state.params_vec)


# -- the riders -------------------------------------------------------------------


def test_ledger_bills_at_realized_width_as_the_reference():
    bpr = {"upload_floats": 20, "download_floats": 100,
           "upload_bytes": 80, "download_bytes": 400}
    feed = [{"fleet/width": 8.0, "fedsim/participation_rate": 1.0,
             "fedsim/dropped": 0.0},
            {"fleet/width": 4.0, "fedsim/participation_rate": 1.0,
             "fedsim/dropped": 0.0},
            {"fleet/width": 4.0, "fedsim/participation_rate": 0.5,
             "fedsim/dropped": 2.0}]
    led = CommLedger(bpr, mode="uncompressed", num_workers=8, masked=True)
    ref = RefLedger(bpr, mode="uncompressed", num_workers=8, masked=True)
    for s, scalars in enumerate(feed):
        assert led.on_round(s, scalars) == ref.on_round(s, scalars)
        if s == 1:
            assert led.live_client_rounds == 12
            assert led.cum_up_bytes == 12 * 80
    assert led.live_client_rounds == 14
    assert led.avail_client_rounds == ref.avail_client_rounds == 14
    for key in ("rounds", "cum_up_bytes", "cum_down_bytes",
                "live_client_rounds"):
        assert getattr(led, key) == getattr(ref, key), key


def test_controller_blob_and_switch_inside_resize_window(data):
    """A 2-rung ``fixed`` ladder switching at round 4, inside
    ``resize@4:rounds=3-5``: the switch dispatches rung 1's width-4
    closure; ``control/rung``, ``fleet/width`` and the controller's blob
    (its bytes accounted at the realized width, blob[8] the live width)
    equal the reference's at every round; the params ``atol 1e-5``."""
    kw = dict(SKETCH, telemetry_level=1, control_policy="fixed",
              ladder="k=40,20;num_cols=256,128",
              control_schedule="0-3=0,4-=1", chaos="resize@4:rounds=3-5")
    sess = _port(data, **kw)
    ctrl = build_controller(sess.cfg, sess, 8)
    assert ctrl.prewarm() == 2
    assert all(set(r.width_fns) == {4} for r in sess.rungs)
    ref = _ref(data, **kw)
    ref_ctrl = ref_control.build_controller(ref.cfg, ref, 8)
    blobs, ref_blobs, got, want = [], [], [], []
    for r, draw in enumerate(data[3]):
        got += _port_rounds(sess, [draw])
        want += _ref_rounds(ref, [draw])
        blobs.append(ctrl.state_blob())
        ref_blobs.append(ref_ctrl.state_blob())
        if r == 4:
            assert sess.active_rung == 1 and sess._fleet_width == 4
            assert sess.round_fn is sess.rungs[1].width_fns[4]
    assert [m["control/rung"] for m in got] == [0, 0, 0, 0, 1, 1, 1, 1]
    for g, w in zip(got, want):
        for k in ("control/rung", "control/switches", "fleet/width"):
            assert g[k] == w[k], k
    assert [b[8] for b in blobs] == [8, 8, 8, 4, 4, 4, 8, 8]
    for b, rb in zip(blobs, ref_blobs):
        np.testing.assert_array_equal(b, rb)
    assert ctrl.snapshot()["fleet_width"] == 8
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec), rtol=0,
                               atol=1e-5)
    # no fleet: blob[8] is -1, as the reference's
    kw0 = {k: v for k, v in kw.items() if k != "chaos"}
    plain = _port(data, **kw0)
    assert build_controller(plain.cfg, plain, 8).state_blob()[8] == -1
    assert "fleet_width" not in plain.controller.snapshot()


def test_hosted_store_resize_bit_equal_to_device_bank(data):
    """Sketch with local momentum under ``resize@4:rounds=1-2``: the
    ``host`` store's run regathers the w rows of each narrow round and
    writes back w ids, bit-equal to the device bank's run (params, banks,
    losses)."""
    kw = dict(SKETCH, local_momentum=0.9, chaos="resize@4:rounds=1-2")
    out = {}
    for store in ("device", "host"):
        sess = _port(data, **kw, client_store=store)
        losses = [m["loss"] for m in _port_rounds(sess, data[3][:4])]
        bank = (sess.host_vel if store == "host"
                else sess.state.client_vel.numpy())
        out[store] = (losses, sess.state.params_vec.clone(), np.array(bank))
        sess.close_client_store()
    assert out["host"][0] == out["device"][0]
    assert torch.equal(out["host"][1], out["device"][1])
    np.testing.assert_array_equal(out["host"][2], out["device"][2])
    # the narrow rounds wrote 4 rows each: only clients drawn in a round's
    # first w slots moved
    moved = {int(c) for r, (ids, _) in enumerate(data[3][:4])
             for c in np.asarray(ids)[:(4 if r in (1, 2) else 8)]}
    rows = {int(c) for c in np.flatnonzero(np.abs(out["host"][2]).sum(1))}
    assert rows == moved


def test_two_gloo_ranks_fleet(data, tmp_path_factory):
    """Two gloo ranks under ``resize@4:rounds=1-2,leave@2:rounds=3-``
    (widths 8, 4, 4, 6: multiples of 2): both ranks hold the same state
    bit for bit, and one process's run agrees (losses ``rtol 1e-6``, params
    ``atol 1e-6``: the group sums two ranks' partial sums, one process its
    clients in order); the group's width-4 round is bit-equal to a group
    provisioned at 4."""
    ds, params, _, draws = data
    arrays = {f"{layer}/{leaf}": np.asarray(params["params"][layer][leaf])
              for layer in ("Dense_0", "Dense_1")
              for leaf in ("kernel", "bias")}
    arrays["ids"] = np.stack([ids for ids, _ in draws[:4]])
    arrays["x"] = np.stack([b["x"] for _, b in draws[:4]])
    arrays["y"] = np.stack([b["y"] for _, b in draws[:4]])
    two = {**BASE, **TOPK, "num_devices": 2}
    plan = "resize@4:rounds=1-2,leave@2:rounds=3-"
    cases = {"fleet": {**two, "chaos": plan},
             "w4_fleet": {**two, "chaos": "resize@4:rounds=0-"},
             "w4_native": {**two, "num_workers": 4,
                           "chaos": "dropout@0.0:rounds=0-0"}}
    outs = spawn({"lr": LR, "cases": cases}, arrays, 2, tmp_path_factory)
    for key in ("losses", "params", "momentum", "error"):
        np.testing.assert_array_equal(outs[0][f"fleet/{key}"],
                                      outs[1][f"fleet/{key}"])
    for key in ("losses", "params"):
        np.testing.assert_array_equal(outs[0][f"w4_fleet/{key}"],
                                      outs[0][f"w4_native/{key}"])
    one = _port(data, **TOPK, chaos=plan)
    got = _port_rounds(one, draws[:4])
    assert [m["fleet/width"] for m in got] == [8.0, 4.0, 4.0, 6.0]
    np.testing.assert_allclose(outs[0]["fleet/losses"],
                               [m["loss"] for m in got], rtol=1e-6)
    np.testing.assert_allclose(outs[0]["fleet/params"],
                               one.state.params_vec.numpy(), rtol=0,
                               atol=1e-6)


def test_plan_builds_stay_put_across_transitions(data):
    """The kernels' host plans are per spec, not per width: on the CPU
    a fleet run builds none (the card's count is ``chip_smoke.py``'s)."""
    before = kern.plan_builds()
    sess = _port(data, **SKETCH, chaos="leave@4:rounds=2-,join@2:rounds=6-")
    sess.prewarm_rungs()
    got = _port_rounds(sess, data[3])
    assert [m["fleet/width"] for m in got] == [8, 8, 4, 4, 4, 4, 6, 6]
    assert all(np.isfinite(m["loss"]) for m in got)
    assert kern.plan_builds() == before


def test_skip_clients_suspects_a_fleet_round_by_its_width(data):
    """``skip_clients`` names a round's suspects from its realized masks:
    inside a resize window the masks have w slots and the suspects come
    from the first w of the sampler's base-width draw."""
    from commefficient_tpu_torch.resilience import build_resilience

    sess = _port(data, **TOPK, recover_policy="skip_clients",
                 chaos="resize@4:rounds=1-,nan_client@2")
    cfg = sess.cfg
    sampler = FedSampler(FedDataset(data[0].data, cfg.num_clients, iid=True,
                                    seed=0), num_workers=cfg.num_workers,
                         local_batch_size=cfg.local_batch_size, seed=1)
    rider = build_resilience(cfg, sess, sampler)
    ids = np.asarray(sampler.sample_round_indices(2)[0])
    env = sess.fedsim_env.round_env(2)
    assert env.live.shape == (4,) and env.corrupt.sum() == 1
    got = rider.manager.suspect_clients(2)
    assert got.tolist() == [int(ids[:4][env.corrupt > 0][0])]
    rider.close()

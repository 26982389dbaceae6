"""The port's control plane (``commefficient_tpu_torch/control/``, the
session's rungs, the compressors' ``migrate_state``, the per-rung ledger,
the checkpoint's controller blob) against the reference, on the CPU, at
TinyMLP size.

* the ladder and schedule grammars and the ``Config`` checks, on the
  reference's own cases (tests/test_control.py): the same values, the
  same refusals with the same messages, ``staleness_aware``'s among them
  (its engine twins are ``tests/test_torch_asyncfed.py``'s);
* the ``fixed``, ``budget_pacing`` and ``ef_feedback`` policies of both
  packages fed one and the same scalar stream: the same decisions and the
  same state slots, round by round; ``ef_feedback``'s hysteresis holds
  for any signal (hypothesis);
* ``migrate_state``: identity for a dense ``k`` switch and a sketch ``k``
  switch (the same tensor objects), the sketch ``num_cols`` re-sketch
  against the reference's (exact and threshold decodes, ``atol 1e-5 *
  max|table|``, fp32), powersgd's rank truncation and padding;
* a 6-round ``fixed`` ladder session with a ``num_cols`` switch at round
  3 (the dense and the sharded decode), from the reference's initial
  state: params (``atol 1e-5``), momentum
  and error tables (``atol 1e-5 * max|table|``), every round's
  ``control/*`` scalars, the ledger's per-rung rounds and bytes, and the
  controller's blob element by element equal to the reference's; the
  same under fedsim masking (the per-rung live counts and the
  controller's spend equal to the ledger's); the budget clamp and
  ``BudgetExhaustedError`` at the reference's step;
* a checkpoint at the ladder's second rung restored into a fresh session:
  the rung sequence, the blob and every leaf bit-equal to the unbroken
  run; the named refusals of a blob without a controller;
* ``run_train_loop`` with a ladder: the run dir through the reference's
  ``scripts/check_telemetry_schema.py``, depth 2 bit-equal to depth 0
  with a quiesce a switch, a budget run stopping with the ledger and the
  flight dump written;
* two gloo ranks: FSDP ladders (a ``k`` ladder and a ``num_cols``
  ladder) against the reference's 2-device mesh;
* ``control_policy='none'`` builds nothing.
"""

import importlib.util
import json
import math
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import commefficient_tpu.control as ref_control
import commefficient_tpu.control.policy as ref_policy
from commefficient_tpu.compress import get_compressor as ref_get_compressor
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.ops import countsketch as ref_cs
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.telemetry.ledger import CommLedger as RefLedger
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu.utils.logging import (
    drain_round_metrics as ref_drain,
)
import commefficient_tpu_torch.control as port_control
import commefficient_tpu_torch.control.policy as port_policy
from commefficient_tpu_torch.compress import get_compressor
from commefficient_tpu_torch.control import (
    BudgetExhaustedError,
    build_controller,
    controller_header,
)
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.interop import STATE_LEAVES, state_from_jax
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops import countsketch as port_cs
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.telemetry import CommLedger
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer
from commefficient_tpu_torch.utils.config import Config
from commefficient_tpu_torch.utils.logging import (
    MetricsWriter,
    drain_round_metrics,
)
from test_round import BASE, _setup
from test_torch_gloo_worker import spawn
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_sharded_decode import LR, _split, rounds  # noqa: F401
from test_torch_sparse_aggregate import (
    _without_vma_check,
    job_arrays,
    ranks_case,
)

ROOT = Path(__file__).resolve().parents[1]
ONE = {**BASE, "num_devices": 1}
N_ROUNDS = 6
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=40, num_rows=3, num_cols=256, telemetry_level=1)
# the ladder the session twins run: rung 1 halves k and the table
LADDER = dict(control_policy="fixed", ladder="k=40,20;num_cols=256,128",
              control_schedule="0-2=0,3-=1")
# the reference's budget case (tests/test_control.py::_LADDER_BASE)
BUDGET = dict(mode="local_topk", error_type="local",
              topk_method="threshold", telemetry_level=1,
              control_policy="fixed", control_schedule="0-=0",
              ladder="k=60,30,15", budget_mb=0.005)
LEAVES = ("params_vec", "momentum", "error", "client_vel", "client_err",
          "comp")


def _checker():
    """The reference's schema checker, loaded by path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", ROOT / "scripts" / "check_telemetry_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(fn, *args, **kw):
    """``fn`` of the control package of each side: (port's, reference's)
    result, or the exception each raised."""
    out = []
    for pkg in (port_control, ref_control):
        try:
            out.append(getattr(pkg, fn)(*args, **kw))
        except ValueError as e:
            out.append(e)
    return out


# -- grammars and the Config's checks -----------------------------------------


@pytest.mark.parametrize("spec", ["", "k=60000,30000,10000",
                                  " k=50, 25 ; num_cols = 500, 250 ",
                                  "powersgd_rank=4,2"])
def test_ladder_grammar_parses_as_the_reference(spec):
    got, want = _both("parse_ladder", spec)
    assert got == want


@pytest.mark.parametrize("bad", ["k", "k=", "k=a,b", "bogus=1,2",
                                 "k=1,2;k=3,4", "k=10,5;num_cols=100",
                                 "k=0,5"])
def test_ladder_grammar_rejects_as_the_reference(bad):
    got, want = _both("parse_ladder", bad)
    assert isinstance(got, ValueError) and "Grammar" in str(got)
    assert str(got) == str(want)


@pytest.mark.parametrize("spec", ["", "0-99=2,100-199=1,200-=0", "5=1",
                                  "abc", "0-99", "99-0=1", "0-5=1,3-9=0",
                                  "0-=1,50-=0"])
def test_schedule_grammar_as_the_reference(spec):
    got, want = _both("parse_schedule", spec)
    assert type(got) is type(want)
    assert str(got) == str(want) if isinstance(got, ValueError) \
        else got == want


def test_rung_cost_order_and_ladder_configs():
    ok = [{"upload_bytes": 100, "download_bytes": 10},
          {"upload_bytes": 100, "download_bytes": 10},  # a tie is legal
          {"upload_bytes": 50, "download_bytes": 10}]
    assert _both("validate_rung_costs", ok) == [None, None]
    got, want = _both("validate_rung_costs", ok[::-1])
    assert "MORE than" in str(got) and str(got) == str(want)
    kw = dict(mode="powersgd", error_type="virtual", control_policy="fixed",
              control_schedule="0-=0", ladder="powersgd_rank=4,2")
    assert [c.powersgd_rank for c in port_control.ladder_configs(
        Config(**kw))] == [c.powersgd_rank for c in ref_control.ladder_configs(
            RefConfig(**kw))] == [4, 2]
    cfg = Config(mode="true_topk", error_type="virtual",
                 control_policy="budget_pacing", budget_mb=1.0)
    assert cfg.control_enabled and port_control.ladder_configs(cfg) == (cfg,)


# the reference's refusals (tests/test_control.py), over its base config
CONFIG_REFUSALS = [
    (dict(ladder="k=10,5"), "ladder without a controller"),
    (dict(control_policy="ef_feedback", telemetry_level=1), ">= 2"),
    (dict(control_policy="ef_feedback", ladder="k=10,5"), "telemetry_level"),
    (dict(control_policy="budget_pacing"), "budget_mb"),
    (dict(budget_mb=1.0), "control_policy='budget_pacing'"),
    (dict(control_policy="fixed"), "control_schedule"),
    (dict(control_policy="budget_pacing", budget_mb=1.0,
          control_schedule="0-=0"), "fixed"),
    (dict(control_policy="fixed", control_schedule="0-=3", ladder="k=10,5"),
     "rung 3"),
    (dict(control_policy="fixed", control_schedule="0-=0",
          ladder="num_cols=100,50"), "num_cols has no effect"),
    (dict(mode="uncompressed", control_policy="fixed",
          control_schedule="0-=0", ladder="k=10,5"), "k has no effect"),
    (dict(control_policy="ef_feedback", ladder="k=10,5", telemetry_level=1,
          control_ef_up=0.0, control_ef_down=0.0), "dead band"),
    (dict(control_policy="ef_feedback", ladder="k=10,5", telemetry_level=1,
          control_hysteresis=0), "hysteresis"),
    (dict(mode="sketch", control_policy="fixed", control_schedule="0-=0",
          ladder="powersgd_rank=4,2"), "powersgd_rank has no effect"),
    (dict(control_policy="bogus"), "control_policy must be one of"),
]


@pytest.mark.parametrize("kw,msg", CONFIG_REFUSALS)
def test_config_refuses_what_the_reference_refuses(kw, msg):
    kw = {"mode": "true_topk", "error_type": "virtual", **kw}
    with pytest.raises(ValueError, match=msg) as port:
        Config(**kw)
    with pytest.raises(ValueError, match=msg) as ref:
        RefConfig(**kw)
    assert str(port.value) == str(ref.value)


def test_scan_rounds_excludes_the_control_plane_as_the_reference():
    kw = dict(mode="true_topk", error_type="virtual", scan_rounds=2,
              control_policy="budget_pacing", budget_mb=1.0)
    with pytest.raises(ValueError, match="mutually exclusive with the "
                                         "control plane"):
        Config(**kw)


# the reference's staleness_aware consistency refusals
# (tests/test_control.py::test_config_rejects_inconsistent_staleness_aware)
_SA_KW = dict(mode="true_topk", error_type="virtual", telemetry_level=1,
              control_policy="staleness_aware", ladder="k=30,20,10",
              async_buffer=4, async_concurrency=2)


@pytest.mark.parametrize("kw,msg", [
    ({**_SA_KW, "async_buffer": 0, "async_concurrency": 1},
     "async_buffer"),
    ({**_SA_KW, "ladder": "k=30"}, ">= 2"),
    ({**_SA_KW, "telemetry_level": 0}, "telemetry_level"),
    ({**_SA_KW, "control_staleness_hi": 0.4,
      "control_staleness_lo": 0.5}, "must exceed control_staleness_lo"),
    ({**_SA_KW, "control_fill_hi": 0.2, "control_fill_lo": 0.25},
     "control_fill"),
])
def test_staleness_aware_refusals_as_the_reference(kw, msg):
    with pytest.raises(ValueError, match=msg) as port:
        Config(**kw)
    with pytest.raises(ValueError, match=msg) as ref:
        RefConfig(**kw)
    assert str(port.value) == str(ref.value)
    assert isinstance(port_policy.get_policy(Config(**_SA_KW)),
                      port_policy.StalenessAwarePolicy)


# -- the policies on one scalar stream ----------------------------------------


POLICY_CASES = {
    "fixed": dict(control_policy="fixed", ladder="k=30,20,10",
                  control_schedule="0-4=1,5-9=2,12-=0"),
    "budget_pacing": dict(control_policy="budget_pacing",
                          ladder="k=30,20,10", budget_mb=0.0075),
    "ef_feedback": dict(control_policy="ef_feedback", ladder="k=30,20,10",
                        telemetry_level=2, control_ef_up=0.1,
                        control_ef_down=-0.05, control_hysteresis=3,
                        control_fidelity_max=0.6),
}


def _stream(seed, n):
    """A drained-scalar stream: a random walk of the EF residual, a
    fidelity scalar, a non-finite entry now and then."""
    rng = np.random.default_rng(seed)
    ef = 1.0
    out = []
    for t in range(n):
        ef *= float(np.exp(rng.normal(0, 0.15)))
        s = {"diag/ef_residual_norm": np.float32(ef),
             "diag/sketch_est_rel_err": np.float32(rng.uniform(0, 0.9)),
             "loss": np.float32(rng.uniform())}
        if t % 11 == 7:
            s["diag/ef_residual_norm"] = np.float32("nan")
        out.append(s)
    return out


def _drive(pkg, cfg, stream, num_rungs=3, cost=(300, 200, 100)):
    """The controller's loop around a policy (decide, switch, spend,
    observe the drained round), without a session: each round's rung and
    the policy's state slots."""
    pol = pkg.get_policy(cfg)
    rung, last, spent, out = pol.initial_rung(num_rungs), -1, 0, []
    budget = int(cfg.budget_mb * 1e6) if cfg.budget_mb > 0 else None
    for step, scalars in enumerate(stream):
        ctx = pkg.DecisionContext(
            step=step, num_rounds=len(stream), rung=rung,
            num_rungs=num_rungs, round_bytes=lambda r: cost[r],
            spent_bytes=spent, budget_bytes=budget, last_switch_round=last,
            hysteresis=cfg.control_hysteresis)
        nxt = min(max(int(pol.decide(ctx)), 0), num_rungs - 1)
        if nxt != rung:
            rung, last = nxt, step
        spent += cost[rung]
        pol.observe(step, scalars)
        out.append((rung, np.asarray(pol.state(), np.float64)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(POLICY_CASES))
def test_policies_decide_as_the_reference_on_one_stream(name, seed):
    kw = {"mode": "true_topk", "error_type": "virtual",
          **POLICY_CASES[name]}
    stream = _stream(seed, 40)
    got = _drive(port_policy, Config(**kw), stream)
    want = _drive(ref_policy, RefConfig(**kw), stream)
    assert [r for r, _ in got] == [r for r, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len({r for r, _ in got}) > 1  # the stream moves the rung


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(0.05, 20.0), min_size=2, max_size=60),
       st.integers(1, 8))
def test_ef_feedback_never_switches_inside_its_hysteresis(mults, hyst):
    kw = dict(mode="true_topk", error_type="virtual", telemetry_level=1,
              control_policy="ef_feedback", ladder="k=30,20,10",
              control_ef_up=0.05, control_ef_down=-0.05,
              control_hysteresis=hyst)
    ef, stream = 1.0, []
    for m in mults:
        ef *= m
        stream.append({"diag/ef_residual_norm": ef})
    got = [r for r, _ in _drive(port_policy, Config(**kw), stream)]
    assert got == [r for r, _ in _drive(ref_policy, RefConfig(**kw), stream)]
    switches = [t for t in range(1, len(got)) if got[t] != got[t - 1]]
    assert all(b - a >= hyst for a, b in zip(switches, switches[1:]))
    assert len(switches) <= len(got) // hyst + 1


# -- migrate_state ------------------------------------------------------------


def test_migrate_dense_k_is_the_identity():
    cfg = Config(mode="true_topk", error_type="virtual", virtual_momentum=0.9,
                 k=40)
    old = get_compressor(cfg, d=200)
    new = get_compressor(cfg.replace(k=10), d=200)
    m, e = torch.arange(200.0), torch.arange(200.0) * 2
    m2, e2, x2 = old.migrate_state(new, m, e, None)
    assert m2 is m and e2 is e and x2 is None


def test_migrate_sketch_k_is_the_identity():
    cfg = Config(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                 k=40, num_rows=3, num_cols=256)
    spec = port_cs.CountSketch(d=500, c=256, r=3, seed=1)
    old = get_compressor(cfg, d=500, spec=spec)
    new = get_compressor(cfg.replace(k=10), d=500, spec=spec)
    t = torch.ones(spec.table_shape)
    m2, e2, _ = old.migrate_state(new, t, t, None)
    assert m2 is t and e2 is t


@pytest.mark.parametrize("topk_method", ["exact", "threshold"])
def test_migrate_sketch_num_cols_matches_the_reference(topk_method):
    """A table holding a k-sparse signal and noise, migrated 1024 -> 512
    columns: the port's tables equal the reference's to fp32 (``atol
    1e-5 * max|table|``), and the heavy hitters estimate back from the
    new table."""
    d, k = 4000, 8
    kw = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=k, num_rows=5, num_cols=1024, topk_method=topk_method)
    geo = dict(d=d, r=5, seed=3)
    rng = np.random.default_rng(0)
    idx = rng.choice(d, size=k, replace=False)
    vec = (rng.normal(size=d) * 0.01).astype(np.float32)
    vec[idx] = rng.normal(size=k).astype(np.float32) * 10 + 20
    tables = {}
    for side, cs, comp_of, cfg_of, arr in (
            ("port", port_cs, get_compressor, Config, torch.from_numpy),
            ("ref", ref_cs, ref_get_compressor, RefConfig, jnp.asarray)):
        s_old = cs.CountSketch(c=1024, **geo)
        s_new = cs.CountSketch(c=512, **geo)
        cfg = cfg_of(**kw)
        old = comp_of(cfg, d=d, spec=s_old)
        new = comp_of(cfg.replace(num_cols=512), d=d, spec=s_new)
        table = cs.sketch_vec(s_old, arr(vec))
        m2, e2, x2 = old.migrate_state(new, table, table * 0.5,
                                       None if side == "port" else ())
        tables[side] = [np.asarray(m2), np.asarray(e2)]
        assert tuple(m2.shape) == tuple(s_new.table_shape)
    for got, want in zip(tables["port"], tables["ref"]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    spec = port_cs.CountSketch(c=512, **geo)
    est = port_cs.estimate_at(spec, torch.from_numpy(tables["port"][0]),
                              torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(est, vec[idx], rtol=0.2, atol=1.0)


def test_migrate_powersgd_rank_truncates_and_pads():
    cfg = Config(mode="powersgd", error_type="virtual", powersgd_rank=4)
    ref_cfg = RefConfig(mode="powersgd", error_type="virtual",
                        powersgd_rank=4)
    d = 400
    old, new2 = (get_compressor(cfg, d=d),
                 get_compressor(cfg.replace(powersgd_rank=2), d=d))
    r_old, r_new2 = (ref_get_compressor(ref_cfg, d=d),
                     ref_get_compressor(ref_cfg.replace(powersgd_rank=2),
                                        d=d))
    q = old.init_extra_state("cpu")
    m, e = torch.zeros(d), torch.zeros(d)
    # 4 -> 2: the first columns, as the reference keeps them
    _, _, q2 = old.migrate_state(new2, m, e, q)
    _, _, q2_ref = r_old.migrate_state(r_new2, jnp.zeros(d), jnp.zeros(d),
                                       jnp.asarray(q.numpy()))
    assert q2.shape == (old.m, 2)
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q2_ref))
    # 2 -> 4: the kept columns and, after them, the new compressor's own
    # seed-derived columns (the reference draws its own from JAX's PRNG)
    m4, e4, q4 = new2.migrate_state(old, m, e, q2)
    assert m4 is m and e4 is e and q4.shape == (old.m, 4)
    np.testing.assert_array_equal(q4[:, :2].numpy(), q2.numpy())
    np.testing.assert_array_equal(q4[:, 2:].numpy(),
                                  old.init_extra_state("cpu")[:, 2:].numpy())
    cold = get_compressor(cfg.replace(powersgd_warm_start=False), d=d)
    cold2 = get_compressor(cfg.replace(powersgd_warm_start=False,
                                       powersgd_rank=2), d=d)
    assert cold.migrate_state(cold2, m, e, None)[2] is None


# -- ladder sessions against the reference ------------------------------------


@pytest.fixture(scope="module")
def six():
    """(dataset, params, reference loss, 6 rounds' batches)."""
    ds, params, loss_ref = _setup(BASE["num_clients"])
    sampler = RefSampler(ds, num_workers=8, local_batch_size=4, seed=1)
    return (ds, jax.tree.map(np.asarray, params), loss_ref,
            [sampler.sample_round(r) for r in range(N_ROUNDS)])


def _ledger(pkg_ledger, sess):
    rungs = [(sess.rung_bytes_per_round(i), r.compressor)
             for i, r in enumerate(sess.rungs)]
    return pkg_ledger(sess.bytes_per_round(), mode=sess.cfg.mode,
                      num_workers=sess.cfg.num_workers,
                      masked=bool(sess.cfg.fedsim_enabled),
                      compressor=sess.compressor, rungs=rungs)


def _ref_ladder(six, kw):
    """The reference's ladder session over the 6 rounds: its initial
    state, each round's metrics, the session, controller and ledger."""
    _, params, loss_ref, batches = six
    with pytest.MonkeyPatch.context() as mp:
        import commefficient_tpu.parallel.round as ref_round

        mp.setattr(ref_round, "shard_map",
                   _without_vma_check(ref_round.shard_map))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sess = RefSession(RefConfig(**kw), params, loss_ref)
        init = {n: np.asarray(getattr(sess.state, n)) for n in STATE_LEAVES}
        ctrl = ref_control.build_controller(sess.cfg, sess, N_ROUNDS)
        ledger = _ledger(RefLedger, sess)
        pending = [(r, LR, sess.train_round(ids, _split(sess.cfg, b), LR))
                   for r, (ids, b) in enumerate(batches)]
        metrics = [{k: float(v) for k, v in m.items()} for _, _, m in pending]
        ref_drain(pending, None, lambda *a: None, ledger=ledger,
                  controller=ctrl)
    return init, metrics, sess, ctrl, ledger


def _port_ladder(six, kw, init):
    _, params, _, batches = six
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(Config(**kw, device="cpu"),
                                to_numpy_tree(params),
                                classification_loss(torch_tinymlp))
    sess.state = state_from_jax(init)
    ctrl = build_controller(sess.cfg, sess, N_ROUNDS)
    assert ctrl.prewarm() == len(sess.rungs)
    ledger = _ledger(CommLedger, sess)
    pending = [(r, LR, sess.train_round(ids, b, LR))
               for r, (ids, b) in enumerate(batches)]
    metrics = [{k: float(v) for k, v in m.items()} for _, _, m in pending]
    drain_round_metrics(pending, None, lambda *a: None, ledger=ledger,
                        controller=ctrl)
    return metrics, sess, ctrl, ledger


def _assert_ladder_twin(six, kw):
    init, want_m, ref, ref_ctrl, ref_ledger = _ref_ladder(six, kw)
    got_m, sess, ctrl, ledger = _port_ladder(six, kw, init)
    for r, (g, w) in enumerate(zip(got_m, want_m)):
        ctl = sorted(k for k in w if k.startswith("control/"))
        assert sorted(k for k in g if k.startswith("control/")) == ctl
        assert {k: g[k] for k in ctl} == {k: w[k] for k in ctl}, r
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec), rtol=0,
                               atol=1e-5)
    for leaf in ("momentum", "error"):
        want = np.asarray(getattr(ref.state, leaf))
        got = getattr(sess.state, leaf).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))
    np.testing.assert_array_equal(ctrl.state_blob(), ref_ctrl.state_blob())
    got_s, want_s = ledger.summary(), ref_ledger.summary()
    for key in ("rounds", "cum_up_bytes", "cum_down_bytes", "rungs",
                "live_client_rounds", "avail_client_rounds"):
        assert got_s.get(key) == want_s.get(key), key
    return got_m, sess, ctrl, ledger


@pytest.mark.parametrize("decode", ["dense", "sharded"])
def test_fixed_ladder_session_matches_the_reference(six, decode):
    """The ladder's session; under the sharded decode (one device here)
    the migration still decodes the whole replicated table, as the
    reference's does."""
    kw = {**ONE, **SKETCH, **LADDER}
    if decode == "sharded":
        kw.update(topk_method="threshold", sketch_decode="sharded")
    metrics, sess, ctrl, ledger = _assert_ladder_twin(six, kw)
    assert sess.sketch_decode_resolved == decode
    assert [m["control/rung"] for m in metrics] == [0, 0, 0, 1, 1, 1]
    assert ctrl.switches == 1 and sess.active_rung == 1
    assert sess.state.error.shape == sess.rungs[1].spec.table_shape
    s = ledger.summary()
    assert [r["rounds"] for r in s["rungs"]] == [3, 3]
    assert s["cum_up_bytes"] == sum(
        r["rounds"] * r["bytes_per_round"]["upload_bytes"]
        for r in s["rungs"])
    assert ctrl.spent_up == s["cum_up_bytes"]
    assert ctrl.spent_down == s["cum_down_bytes"]


def test_masked_ladder_ledger_matches_the_reference(six):
    kw = {**ONE, **SKETCH, **LADDER, "availability": "bernoulli",
          "dropout_prob": 0.4, "fuse_clients": False}
    _, _, ctrl, ledger = _assert_ladder_twin(six, kw)
    s = ledger.summary()
    assert s["cum_up_bytes"] == sum(
        r["live_client_rounds"] * r["bytes_per_round"]["upload_bytes"]
        for r in s["rungs"])
    assert s["cum_down_bytes"] == sum(
        r["avail_client_rounds"] * r["bytes_per_round"]["download_bytes"]
        for r in s["rungs"])
    assert s["live_client_rounds"] < N_ROUNDS * 8  # some client dropped
    assert (ctrl.spent_up, ctrl.spent_down) == (s["cum_up_bytes"],
                                                s["cum_down_bytes"])


def test_budget_clamp_and_exhaustion_at_the_reference_step(six):
    """A 5000 B budget over per-round bytes of 1328 / 1088 / 968 (rungs
    0-2): rounds 0-2 at rung 0, the clamp demotes round 3 to rung 2, and
    round 4 raises before it runs — in both packages."""
    _, params, loss_ref, batches = six
    kw = {**ONE, **BUDGET}
    used, errors = {}, {}
    for side in ("port", "ref"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if side == "port":
                sess = FederatedSession(Config(**kw, device="cpu"),
                                        to_numpy_tree(params),
                                        classification_loss(torch_tinymlp))
                ctrl = build_controller(sess.cfg, sess, 10)
                err = BudgetExhaustedError
            else:
                sess = RefSession(RefConfig(**kw), params, loss_ref)
                ctrl = ref_control.build_controller(sess.cfg, sess, 10)
                err = ref_control.BudgetExhaustedError
        used[side] = []
        with pytest.raises(err) as ei:
            for ids, b in batches:
                m = sess.train_round(ids, b, LR)
                used[side].append(float(m["control/rung"]))
        assert ctrl.spent_bytes <= 5000
        errors[side] = (ei.value.step, ei.value.budget_bytes,
                        ei.value.spent_bytes, ctrl.state_blob())
        assert "completed 4 full rounds" in str(ei.value)
    assert used["port"] == used["ref"] == [0, 0, 0, 2]
    assert errors["port"][:3] == errors["ref"][:3]
    assert errors["port"][0] == 4
    np.testing.assert_array_equal(errors["port"][3], errors["ref"][3])


# -- checkpoint ---------------------------------------------------------------


def _port_session(six, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return FederatedSession(Config(**{**ONE, **kw}, device="cpu"),
                                to_numpy_tree(six[1]),
                                classification_loss(torch_tinymlp))


def _train(sess, six, start, stop):
    return [float(sess.train_round(ids, b, LR)["control/rung"])
            for ids, b in six[3][start:stop]]


def test_checkpoint_at_the_second_rung_resumes_bit_exact(six, tmp_path):
    kw = {**SKETCH, **LADDER, "checkpoint_dir": str(tmp_path / "ck")}
    straight = _port_session(six, **kw)
    ctrl = build_controller(straight.cfg, straight, N_ROUNDS)
    seq = _train(straight, six, 0, N_ROUNDS)
    first = _port_session(six, **kw)
    build_controller(first.cfg, first, N_ROUNDS)
    seq_first = _train(first, six, 0, 4)
    assert first.active_rung == 1  # switched at round 3
    ck = FedCheckpointer(first.cfg)
    assert ck.maybe_save(first, 4, force=True)
    second = _port_session(six, **kw)
    ctrl2 = build_controller(second.cfg, second, N_ROUNDS)
    assert second.active_rung == 0  # a fresh session starts on the schedule
    assert FedCheckpointer(second.cfg).restore(second) == 4
    assert second.active_rung == 1 and ctrl2.switches == 1
    np.testing.assert_array_equal(ctrl2.state_blob(),
                                  first.controller.state_blob())
    assert seq_first + _train(second, six, 4, N_ROUNDS) == seq
    np.testing.assert_array_equal(ctrl2.state_blob(), ctrl.state_blob())
    for leaf in LEAVES:
        x, y = getattr(straight.state, leaf), getattr(second.state, leaf)
        assert (x is None) == (y is None), leaf
        if x is not None:
            assert torch.equal(x, y), leaf


def test_checkpoint_refusals_between_control_and_no_control(six, tmp_path):
    ck_dir = str(tmp_path / "ck")
    ctl = _port_session(six, **SKETCH, **LADDER, checkpoint_dir=ck_dir)
    build_controller(ctl.cfg, ctl, N_ROUNDS)
    _train(ctl, six, 0, 1)
    FedCheckpointer(ctl.cfg).maybe_save(ctl, 1, force=True)
    plain = _port_session(six, **SKETCH, checkpoint_dir=ck_dir)
    with pytest.raises(ValueError, match="without a controller"):
        FedCheckpointer(plain.cfg).restore(plain, step=1)
    # a checkpoint without a blob restores into a controlled session,
    # with the reference's warning
    ck2 = str(tmp_path / "ck2")
    plain = _port_session(six, **SKETCH, checkpoint_dir=ck2)
    for ids, b in six[3][:1]:
        plain.train_round(ids, b, LR)
    FedCheckpointer(plain.cfg).maybe_save(plain, 1, force=True)
    ctl = _port_session(six, **SKETCH, **LADDER, checkpoint_dir=ck2)
    build_controller(ctl.cfg, ctl, N_ROUNDS)
    with pytest.warns(UserWarning, match="predates the adaptive"):
        assert FedCheckpointer(ctl.cfg).restore(ctl) == 1


# -- the train loop -----------------------------------------------------------


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


def _loop(six, tmp_path, name, **kw):
    """``run_train_loop`` for N_ROUNDS rounds with a metrics writer: (the
    session, the run dir, the engine's stats)."""
    sess = _port_session(six, **{**SKETCH, **kw, "max_rounds": N_ROUNDS,
                                 "num_epochs": 2})
    cfg = sess.cfg
    sampler = FedSampler(FedDataset(six[0].data, BASE["num_clients"],
                                    iid=True, seed=0),
                         num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size, seed=1)
    writer = MetricsWriter(str(tmp_path / name), cfg=cfg,
                           extra_header=controller_header(sess))
    stats = {}
    try:
        run_train_loop(cfg, sess, sampler, _Hooks(), writer=writer,
                       engine_stats=stats)
    finally:
        writer.close()
    return sess, tmp_path / name, stats


def _rungs_logged(run_dir):
    return [rec["value"] for rec in map(
        json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
        if rec.get("name") == "control/rung"]


def test_train_loop_run_dir_passes_the_checker_and_depth2_is_bit_exact(
        six, tmp_path):
    d0, run0, _ = _loop(six, tmp_path, "d0", **LADDER)
    d2, run2, stats = _loop(six, tmp_path, "d2", **LADDER, pipeline_depth=2)
    for leaf in LEAVES:
        x, y = getattr(d0.state, leaf), getattr(d2.state, leaf)
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y), leaf
    assert stats["quiesces"] == d2.controller.switches == 1
    checker = _checker()
    for run_dir in (run0, run2):
        checker.validate_run_dir(run_dir)
        assert _rungs_logged(run_dir) == [0, 0, 0, 1, 1, 1]
        header = json.loads((run_dir / "metrics.jsonl").read_text()
                            .splitlines()[0])
        assert header["controller"] == {"policy": "fixed",
                                        "ladder": LADDER["ladder"],
                                        "rung": 0, "num_rungs": 2}
        led = json.loads((run_dir / "comm_ledger.json").read_text())
        assert [r["rounds"] for r in led["rungs"]] == [3, 3]
    spans = json.loads(next(run2.glob("spans_*.json")).read_text())
    names = [e.get("name") for e in spans["traceEvents"]]
    assert "pipeline_quiesce:rung0->rung1" in names


def test_train_loop_budget_stop_drains_and_dumps(six, tmp_path):
    """budget_pacing with a budget of 3.5 rounds at the cheaper rung: the
    pacing picks rung 1 from round 0, round 3 raises before it runs, the
    ledger bills rounds 0-2 and the flight dump names the policy."""
    probe = _port_session(six, **SKETCH, control_policy="budget_pacing",
                          ladder=LADDER["ladder"], budget_mb=1.0)
    cost = sum(probe.rung_bytes_per_round(1)[k]
               for k in ("upload_bytes", "download_bytes"))
    budget = 3.5 * cost / 1e6
    with pytest.raises(BudgetExhaustedError) as ei:
        _loop(six, tmp_path, "budget", control_policy="budget_pacing",
              ladder=LADDER["ladder"], budget_mb=budget)
    assert ei.value.step == 3 and ei.value.spent_bytes == 3 * cost
    run_dir = tmp_path / "budget"
    led = json.loads((run_dir / "comm_ledger.json").read_text())
    assert led["rounds"] == 3 and led["cum_bytes"] == 3 * cost
    assert [r["rounds"] for r in led["rungs"]] == [0, 3]
    dump = json.loads(next(run_dir.glob("flight_*.json")).read_text())
    assert dump["controller"]["policy"] == "budget_pacing"
    assert dump["controller"]["budget_remaining_bytes"] == int(
        budget * 1e6) - 3 * cost
    assert "budget exhausted" in dump["reason"]
    _checker().validate_run_dir(run_dir)


# -- two gloo ranks: FSDP ladders ---------------------------------------------


TWO = {**BASE, "num_devices": 2}
FSDP_LADDERS = {
    "fsdp_true_topk_k": dict(mode="true_topk", error_type="virtual",
                             virtual_momentum=0.9, fsdp=True,
                             topk_method="threshold", telemetry_level=1,
                             control_policy="fixed",
                             control_schedule="0-1=0,2-=1",
                             ladder="k=40,20"),
    "fsdp_sketch_num_cols": dict(mode="sketch", error_type="virtual",
                                 virtual_momentum=0.9, fsdp=True,
                                 topk_method="threshold", k=40, num_rows=3,
                                 num_cols=256, control_policy="fixed",
                                 control_schedule="0-1=0,2-=1",
                                 ladder="num_cols=256,128"),
}


@pytest.fixture(scope="module")
def control_ranks(rounds, tmp_path_factory):
    job = {"lr": LR, "control": {n: {**TWO, **kw}
                                 for n, kw in FSDP_LADDERS.items()}}
    return spawn(job, job_arrays(rounds), 2, tmp_path_factory)


@pytest.mark.parametrize("name", sorted(FSDP_LADDERS))
def test_fsdp_ladder_switch_on_two_gloo_ranks_matches_reference(
        rounds, control_ranks, name):
    _, params, loss_ref, batches = rounds
    kw = {**TWO, **FSDP_LADDERS[name]}
    with pytest.MonkeyPatch.context() as mp:
        import commefficient_tpu.parallel.round as ref_round

        mp.setattr(ref_round, "shard_map",
                   _without_vma_check(ref_round.shard_map))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = RefSession(RefConfig(**kw), params, loss_ref)
        ctrl = ref_control.build_controller(ref.cfg, ref, len(batches))
        want_rungs = [float(ref.train_round(ids, b, LR)["control/rung"])
                      for ids, b in batches]
    got = ranks_case(control_ranks, f"ctl:{name}")
    assert want_rungs == got["rungs"].tolist() == [0, 0, 1, 1]
    np.testing.assert_array_equal(got["blob"], ctrl.state_blob())
    np.testing.assert_allclose(got["params"],
                               np.asarray(ref.state.params_vec)[
                                   :got["params"].size], rtol=0, atol=1e-5)
    for leaf in ("momentum", "error"):
        want = np.asarray(getattr(ref.state, leaf))
        np.testing.assert_allclose(got[leaf], want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))


# -- control_policy='none' ----------------------------------------------------


def test_control_none_builds_nothing(six):
    sess = _port_session(six, **SKETCH)
    assert len(sess.rungs) == 1 and sess.rungs[0].label == ""
    assert sess.controller is None and controller_header(sess) == {}
    assert build_controller(sess.cfg, sess, N_ROUNDS) is None
    m = sess.train_round(*six[3][0], LR)
    assert not any(k.startswith("control/") for k in m)
    assert sess.prewarm_rungs() == 1
    assert math.isfinite(float(m["loss"]))

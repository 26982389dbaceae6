"""The port's fedsim (partial participation and chaos) and worker-side DP
noise against the JAX package, on the CPU, at tests/test_round.py's
TinyMLP size.

fedsim: the port's own numpy copy of ``fedsim/`` draws the reference's
masks, corruption flags and realized chaos events element for element,
for every availability model and chaos plan; a masked round with live
cohort S equals the round over exactly S for all six modes (atol 1e-6, as
tests/test_fedsim.py's ``test_masked_round_unbiased_per_mode``) and the
reference's masked run (the twins' bounds of test_torch_compressors.py);
a dropped client's bank rows carry forward, a corrupt flag on a dead
client cannot poison the aggregate, a round where every client drops
freezes params and server state; bad knobs, and the fleet and preempt
kinds (ROADMAP A11), are refused. Masking on two gloo ranks is held in
tests/test_torch_sharded_decode.py (its fixture).

DP: the port's gradient minus its own recorded draw equals the
reference's clipped gradient with DP off; the draw's mean and std lie
within ``5 / sqrt(n)`` and ``5 / sqrt(2 n)`` of 0 and 1 at n = 200,000
(the bounds chip_smoke.py's ``dp`` phase holds the card to); draws are
reproducible for one (seed, step, client) and differ across clients and
rounds; a DP round is the noiseless round plus ``lr * sigma / W`` times
the clients' draws. JAX's threefry normals are not reproduced: parity
is statistical.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.fedsim import available_models as ref_models
from commefficient_tpu.fedsim import parse_chaos as ref_parse_chaos
from commefficient_tpu.fedsim.env import FedEnvironment as RefEnvironment
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.parallel.round import make_grad_one as ref_grad_one
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.fedsim import (
    FedEnvironment,
    RoundEnv,
    available_models,
    parse_chaos,
    validate_chaos_rounds,
)
from commefficient_tpu_torch.interop import (
    STATE_LEAVES,
    state_from_jax,
    state_to_jax,
)
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.parallel.round import (
    dp_noise,
    dp_seed,
    make_grad_one,
)
from commefficient_tpu_torch.utils.config import (
    AVAILABILITY_MODELS,
    Config,
)
from test_fedsim import MODE_CONFIGS, S
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

ONE = {**BASE, "num_devices": 1}
PLANS = ["", "dropout@0.3:rounds=2-9,straggler@0.2,nan_client@4",
         "nan_client@2:rounds=1-6,straggler@0.4:rounds=3-"]


@pytest.fixture(scope="module")
def setup():
    ds, params, loss_ref = _setup(BASE["num_clients"])
    return ds, jax.tree.map(np.asarray, params), loss_ref


# -- the draws ----------------------------------------------------------------


def test_availability_registry_matches_config_and_reference():
    assert available_models() == AVAILABILITY_MODELS == ref_models()


def _knobs(model, plan):
    return dict(num_workers=8, seed=5, availability=model,
                dropout_prob=0.0 if model == "always" else 0.4,
                availability_period=6, num_cohorts=3, arrival_rate=0.8,
                chaos=plan)


@pytest.mark.parametrize("model", AVAILABILITY_MODELS)
def test_draws_equal_reference(model):
    """Masks, corruption flags, live counts and the fedsim/* scalars of
    20 rounds, first pass and replay, and the parsed plans."""
    for plan in PLANS:
        kw = _knobs(model, plan)
        if model == "always" and not plan:
            continue  # fedsim off: no environment
        ref = RefEnvironment(RefConfig(**kw, num_clients=12))
        port = FedEnvironment(Config(**kw, num_clients=12))
        assert [tuple(vars(e).values()) for e in port.plan] == [
            tuple(vars(e).values()) for e in ref.plan]
        for r in range(20):
            for replay in (False, True):
                want = ref.round_env(r, replay=replay)
                got = port.round_env(r, replay=replay)
                np.testing.assert_array_equal(got.live, want.live)
                np.testing.assert_array_equal(got.corrupt, want.corrupt)
                assert got.live_count == want.live_count
                assert got.stats == {k: want.stats[k] for k in got.stats}


def test_chaos_plan_parses_as_the_reference():
    for spec in ["dropout@0.3:rounds=50-100,nan_client@120,straggler@0.2",
                 "dropout@0.5:rounds=7-7", "nan_client@3:rounds=1-2",
                 "straggler@0.1:rounds=4-"]:
        assert [vars(e) for e in parse_chaos(spec)] == [
            vars(e) for e in ref_parse_chaos(spec)]
    for bad in ["bogus@1", "dropout@1.5", "dropout@x",
                "dropout@0.3:rounds=9-5", "dropout@0.3:r=5", "nan_client@-1",
                "nan_client@1.5", "nan_client@0:rounds=1-2", "dropout"]:
        with pytest.raises(ValueError, match="chaos"):
            parse_chaos(bad)
        with pytest.raises(ValueError, match="chaos"):
            ref_parse_chaos(bad)
    plan = parse_chaos("dropout@0.3:rounds=50-100,nan_client@120")
    validate_chaos_rounds(plan, 121)
    with pytest.raises(ValueError, match="120"):
        validate_chaos_rounds(plan, 120)


@pytest.mark.parametrize("kw,match", [
    (dict(dropout_prob=-0.1), r"dropout_prob"),
    (dict(dropout_prob=1.0), r"dropout_prob"),
    (dict(availability="bogus"), r"availability"),
    (dict(dropout_prob=0.5), r"always"),
    (dict(availability="sine", dropout_prob=0.5, availability_period=0),
     r"availability_period"),
    (dict(availability="cohort", dropout_prob=0.5, num_cohorts=0),
     r"num_cohorts"),
    (dict(chaos="dropout@1.5"), r"chaos"),
    (dict(availability="poisson", arrival_rate=0.0), r"arrival_rate"),
    (dict(num_workers=6, num_devices=4, num_clients=8), r"mask"),
])
def test_config_rejects_bad_fedsim_knobs(kw, match):
    with pytest.raises(ValueError, match=match):
        Config(**kw)


@pytest.mark.parametrize("plan", ["resize@4", "leave@2", "join@2:rounds=3-",
                                  "shrink@4:rounds=2-", "preempt@3"])
def test_fleet_and_preempt_kinds_refused_naming_a11(plan):
    assert parse_chaos(plan)  # the reference's grammar parses them
    with pytest.raises(ValueError, match="ROADMAP A11"):
        Config(chaos=plan)


def test_fedsim_enabled_gate_is_the_references():
    for kw in (dict(), dict(availability="bernoulli", dropout_prob=0.3),
               dict(chaos="nan_client@1"), dict(availability="poisson")):
        assert Config(**kw).fedsim_enabled == RefConfig(**kw).fedsim_enabled
    assert not Config().fedsim_enabled


# -- the masked round ---------------------------------------------------------


def _env(live_slots, W=8, corrupt_slot=None):
    live = np.zeros(W, np.float32)
    live[list(live_slots)] = 1.0
    corrupt = np.zeros(W, np.float32)
    if corrupt_slot is not None:
        corrupt[corrupt_slot] = 1.0
    n = float(live.sum())
    return RoundEnv(live, corrupt, np.float32(n), {
        "fedsim/participation_rate": n / W, "fedsim/dropped": W - n,
        "fedsim/straggler_excluded": 0.0, "fedsim/all_dropped": float(n == 0)})


def _port_rounds(setup, kw, env=None, subset=None, n_rounds=3, lr=0.3,
                 ref_state=None):
    ds, params, _ = setup
    sess = FederatedSession(Config(**kw, device="cpu"), to_numpy_tree(params),
                            classification_loss(torch_tinymlp))
    if ref_state is not None:
        sess.state = state_from_jax(ref_state)
    sampler = RefSampler(ds, num_workers=8,
                         local_batch_size=sess.cfg.sampler_batch_size, seed=1)
    metrics = []
    for r in range(n_rounds):
        ids, batch = sampler.sample_round(r)
        batch = microbatched(sess.cfg, batch)
        if subset is not None:
            ids, batch = ids[subset], {k: v[subset] for k, v in batch.items()}
        metrics.append(sess.train_round(ids, batch, lr, env=env))
    return sess, metrics


def _masked_kw(name, **extra):
    kw = dict(MODE_CONFIGS[name])
    base = {**ONE, "local_batch_size": kw.pop("local_batch_size",
                                              ONE["local_batch_size"])}
    return {**base, **kw, "availability": "bernoulli", "dropout_prob": 0.5,
            **extra}


@pytest.mark.parametrize("name", sorted(MODE_CONFIGS))
def test_masked_round_equals_live_cohort_round(setup, name):
    kw = _masked_kw(name)
    masked, metrics = _port_rounds(setup, kw, env=_env(S))
    oracle_kw = {k: v for k, v in kw.items()
                 if k not in ("availability", "dropout_prob")}
    oracle, _ = _port_rounds(setup, {**oracle_kw, "num_workers": len(S)},
                             subset=S)
    assert metrics[-1]["fedsim/participation_rate"] == len(S) / 8
    np.testing.assert_allclose(masked.state.params_vec.numpy(),
                               oracle.state.params_vec.numpy(), rtol=0,
                               atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["sketch", "local_topk", "powersgd"])
def test_masked_run_equals_reference_masked_run(setup, name):
    """Both sessions draw their own masks (bernoulli 0.5 plus a straggler
    plan) from the same seed; three rounds, every state leaf."""
    ds, params, loss_ref = setup
    kw = _masked_kw(name, chaos="straggler@0.2")
    ref = RefSession(RefConfig(**kw), params, loss_ref)
    ref_state = {n: np.asarray(getattr(ref.state, n)) for n in STATE_LEAVES}
    sampler = RefSampler(ds, num_workers=8,
                         local_batch_size=ref.cfg.local_batch_size
                         * (ref.cfg.round_microbatches or 1), seed=1)
    want_loss = []
    for r in range(3):
        ids, batch = sampler.sample_round(r)
        m = ref.train_round(ids, microbatched(ref.cfg, batch), 0.3)
        want_loss.append(float(m["loss"]))
    port, metrics = _port_rounds(setup, kw, ref_state=ref_state)
    np.testing.assert_allclose([float(m["loss"]) for m in metrics],
                               want_loss, rtol=1e-4)
    got = state_to_jax(port.state)
    for leaf in STATE_LEAVES:
        w = np.asarray(getattr(ref.state, leaf))
        if w.size and leaf != "step":
            np.testing.assert_allclose(
                np.asarray(got[leaf]), w, rtol=0,
                atol=1e-5 * max(np.abs(w).max(), 1.0), err_msg=leaf)
    assert port.state.step == 3


def test_masked_round_leaves_dropped_client_state_untouched(setup):
    sess, _ = _port_rounds(setup, _masked_kw("local_topk"), env=_env(S),
                           n_rounds=1)
    ids, _ = RefSampler(setup[0], num_workers=8, local_batch_size=4,
                        seed=1).sample_round(0)
    dropped = np.setdiff1d(np.arange(8), S)
    err, vel = sess.state.client_err.numpy(), sess.state.client_vel.numpy()
    assert np.all(err[ids[dropped]] == 0.0)
    assert np.all(vel[ids[dropped]] == 0.0)
    assert np.any(err[ids[S]] != 0.0)


def test_corrupt_flag_on_dead_client_cannot_poison(setup):
    kw = _masked_kw("uncompressed")
    assert 1 not in S
    sess, m = _port_rounds(setup, kw, env=_env(S, corrupt_slot=1),
                           n_rounds=1)
    assert torch.isfinite(sess.state.params_vec).all()
    assert np.isfinite(float(m[-1]["loss"]))
    # a LIVE corrupted client does poison it: the path is real
    sess, _ = _port_rounds(setup, kw, env=_env(S, corrupt_slot=int(S[0])),
                           n_rounds=1)
    assert not torch.isfinite(sess.state.params_vec).all()


@pytest.mark.parametrize("name", ["uncompressed", "sketch", "powersgd"])
def test_all_dropped_round_freezes_everything(setup, name):
    sess, _ = _port_rounds(setup, _masked_kw(name), env=_env(S), n_rounds=2)
    before = {f: getattr(sess.state, f) for f in ("params_vec", "momentum",
                                                  "error", "comp")}
    ids, batch = RefSampler(setup[0], num_workers=8,
                            local_batch_size=sess.cfg.sampler_batch_size,
                            seed=1).sample_round(5)
    m = sess.train_round(ids, microbatched(sess.cfg, batch), 0.3,
                         env=_env([]))
    assert m["fedsim/all_dropped"] == 1.0
    for f, t in before.items():
        if t is not None:
            assert torch.equal(getattr(sess.state, f), t), f
    assert np.isfinite(float(m["loss"]))
    assert sess.state.step == 3  # the round still counts


def test_session_draws_round_step_env_and_reports_it(setup):
    kw = _masked_kw("uncompressed", chaos="straggler@0.3")
    sess, metrics = _port_rounds(setup, kw, n_rounds=3)
    env = FedEnvironment(sess.cfg)
    for r, m in enumerate(metrics):
        want = env.round_env(r).stats
        assert {k: m[k] for k in want} == want


def test_env_override_on_disabled_session_rejected(setup):
    with pytest.raises(ValueError, match="fedsim_enabled"):
        _port_rounds(setup, {**ONE, "mode": "uncompressed"}, env=_env(S),
                     n_rounds=1)


# -- worker-side DP -----------------------------------------------------------

DP = dict(mode="uncompressed", max_grad_norm=0.5, dp_noise_multiplier=0.7)


def test_clipped_part_equals_reference_without_dp(setup):
    ds, params, loss_ref = setup
    vec, unravel = ravel_pytree(params)
    ref_fn = ref_grad_one(RefConfig(**{**ONE, **DP,
                                       "dp_noise_multiplier": 0.0}),
                          loss_ref, unravel)
    ids, batch = RefSampler(ds, num_workers=8, local_batch_size=4,
                            seed=1).sample_round(0)
    b0 = {k: v[0] for k, v in batch.items()}
    want = np.asarray(jax.jit(ref_fn)(vec, b0, jax.random.key(0))[0])
    pvec, punravel = ravel_params(to_numpy_tree(params))
    cfg = Config(**{**ONE, **DP}, device="cpu")
    g, _, _ = make_grad_one(cfg, classification_loss(torch_tinymlp),
                            punravel)(pvec, {k: torch.from_numpy(v)
                                             for k, v in b0.items()},
                                      (3, 7))
    sigma = cfg.dp_noise_multiplier * cfg.max_grad_norm
    clipped = g - sigma * dp_noise(cfg.seed, (3, 7), g.numel(), "cpu")
    np.testing.assert_allclose(clipped.numpy(), want, rtol=0, atol=1e-6)
    assert np.linalg.norm(want) <= cfg.max_grad_norm * (1 + 1e-5)


def test_noise_statistics_within_bounds():
    n = 200_000
    for key in [(0, 0), (5, 3), (17, 11, 1)]:
        x = dp_noise(42, key, n, "cpu").double()
        assert abs(float(x.mean())) <= 5 / n ** 0.5
        assert abs(float(x.std()) - 1.0) <= 5 / (2 * n) ** 0.5


def test_noise_reproducible_and_distinct_across_clients_and_rounds():
    a = dp_noise(42, (3, 7), 1000, "cpu")
    assert torch.equal(a, dp_noise(42, (3, 7), 1000, "cpu"))
    for other in [(3, 8), (4, 7), (3, 7, 0)]:
        b = dp_noise(42, other, 1000, "cpu")
        assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.2
    assert dp_seed(42, 3, 7) != dp_seed(43, 3, 7)


def test_dp_without_clip_refused():
    with pytest.raises(ValueError, match="max_grad_norm"):
        Config(dp_noise_multiplier=0.5)


def test_dp_round_is_noiseless_round_plus_the_clients_draws(setup):
    lr = 0.3
    dp, _ = _port_rounds(setup, {**ONE, **DP}, n_rounds=1, lr=lr)
    clean, _ = _port_rounds(setup, {**ONE, **DP, "dp_noise_multiplier": 0.0},
                            n_rounds=1, lr=lr)
    ids, _ = RefSampler(setup[0], num_workers=8, local_batch_size=4,
                        seed=1).sample_round(0)
    cfg = dp.cfg
    noise = sum(dp_noise(cfg.seed, (0, int(c)), dp.grad_size, "cpu")
                for c in ids)
    sigma = cfg.dp_noise_multiplier * cfg.max_grad_norm
    want = clean.state.params_vec - lr * sigma / 8 * noise
    np.testing.assert_allclose(dp.state.params_vec.numpy(), want.numpy(),
                               rtol=0, atol=1e-6)

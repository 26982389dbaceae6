"""The port's round, session, data pipeline and entry point against the
reference, on the CPU.

The twins use tests/test_round.py's TinyMLP, ``BASE`` shapes and sampler,
one device, and the reference's initial params carried over as numpy.
Tolerances: per-round losses ``rtol 1e-4`` and final params ``atol 1e-5``
(the reference's own single-vs-multi-device bounds in test_round.py): the
port sums client gradients and sketch buckets in another fp32 order.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.data import FedDataset as RefDataset
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.data import cifar as ref_cifar
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.data import cifar as port_cifar
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.utils.config import _UNPORTED, Config, parse_args
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

TWINS = {
    "uncompressed": dict(mode="uncompressed"),
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=60, num_rows=5, num_cols=512),
    "uncompressed_momentum_wd": dict(mode="uncompressed",
                                     virtual_momentum=0.9,
                                     weight_decay=5e-4, max_grad_norm=1.0),
}


@pytest.mark.parametrize("case", sorted(TWINS))
def test_four_round_twins_match_reference(case):
    kw = {**BASE, "num_devices": 1, **TWINS[case]}
    ds, params, loss_ref = _setup(kw["num_clients"])
    ref_sess = RefSession(RefConfig(**kw), params, loss_ref)
    port_sess = FederatedSession(Config(**kw, device="cpu"),
                                 to_numpy_tree(params),
                                 classification_loss(torch_tinymlp))
    assert port_sess.grad_size == ref_sess.grad_size
    assert port_sess.bytes_per_round() == ref_sess.bytes_per_round()
    ref_sampler = RefSampler(ds, num_workers=8, local_batch_size=4, seed=1)
    port_sampler = FedSampler(
        FedDataset(ds.data, kw["num_clients"], iid=True, seed=0),
        num_workers=8, local_batch_size=4, seed=1)
    l_ref, l_port = [], []
    for r in range(4):
        ids, batch = ref_sampler.sample_round(r)
        ids_p, batch_p = port_sampler.sample_round(r)
        np.testing.assert_array_equal(ids_p, ids)  # identical draws
        for k in batch:
            np.testing.assert_array_equal(batch_p[k], batch[k])
        l_ref.append(float(ref_sess.train_round(ids, batch, 0.3)["loss"]))
        l_port.append(float(port_sess.train_round(ids_p, batch_p,
                                                  0.3)["loss"]))
    np.testing.assert_allclose(l_port, l_ref, rtol=1e-4)
    np.testing.assert_allclose(port_sess.state.params_vec.numpy(),
                               np.asarray(ref_sess.state.params_vec),
                               rtol=0, atol=1e-5)
    if case == "sketch":  # the sketched server state agrees too
        for name in ("momentum", "error"):
            want = np.asarray(getattr(ref_sess.state, name))
            got = getattr(port_sess.state, name).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * max(np.abs(want).max(), 1))


def test_cifar_pipeline_draws_equal_reference():
    """Synthetic stand-ins, client split, sampler and augmentation give
    the reference's arrays for the same seed."""
    for gen in ("_synthetic_cifar", "_synthetic_cifar_concentrated"):
        a = getattr(ref_cifar, gen)(10, n_train=96, n_test=16, seed=3)
        b = getattr(port_cifar, gen)(10, n_train=96, n_test=16, seed=3)
        for split_a, split_b in zip(a, b):
            for k in split_a:
                np.testing.assert_array_equal(split_b[k], split_a[k])
    train = a[0]
    for iid in (True, False):
        ref_s = RefSampler(RefDataset(train, 6, iid=iid, seed=4),
                           num_workers=3, local_batch_size=5, seed=9,
                           augment=ref_cifar.CifarAugment())
        port_s = FedSampler(FedDataset(train, 6, iid=iid, seed=4),
                            num_workers=3, local_batch_size=5, seed=9,
                            augment=port_cifar.CifarAugment())
        assert port_s.steps_per_epoch() == ref_s.steps_per_epoch()
        for r in range(3):
            ids, batch = ref_s.sample_round(r)
            ids_p, batch_p = port_s.sample_round(r)
            np.testing.assert_array_equal(ids_p, ids)
            for k in batch:
                np.testing.assert_array_equal(batch_p[k], batch[k])
    x = train["x"][:8]
    want = np.asarray(ref_cifar.device_normalizer(
        ref_cifar.CIFAR10_MEAN, ref_cifar.CIFAR10_STD)(jnp.asarray(x)))
    got = port_cifar.normalizer(port_cifar.CIFAR10_MEAN,
                                port_cifar.CIFAR10_STD)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_schedule_matches_reference():
    from commefficient_tpu.utils.schedule import piecewise_linear_lr as ref
    from commefficient_tpu_torch.utils.schedule import piecewise_linear_lr

    kw = dict(steps_per_epoch=7, pivot_epoch=5, num_epochs=24, lr_scale=0.4)
    for s in range(0, 7 * 25):
        assert piecewise_linear_lr(s, **kw) == ref(s, **kw)


@pytest.mark.parametrize("flag,value,item", [
    ("scan_rounds", "2", "A11"),
    ("model_axis", "2", "A17"),
    ("max_retraces", "2", "A11"),
    ("chaos", "resize@2", "A11"),
])
def test_config_refuses_what_the_port_does_not_run(flag, value, item):
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        parse_args([f"--{flag}", value, "--num_workers", "2",
                    "--num_clients", "4"])


# the fields ROADMAP A10b, A8, A13, A11a, A15, A9, A12a, A12b and A11's
# control/, resilience/, clientstore/ and asyncfed/ lifted from the
# refusals
_EF = ["--mode", "true_topk", "--telemetry_level", "1", "--control_policy",
       "ef_feedback", "--ladder", "k=10,5"]
_SA = ["--mode", "true_topk", "--telemetry_level", "1", "--control_policy",
       "staleness_aware", "--ladder", "k=10,5", "--async_buffer", "2"]
LIFTED = {
    "topk_method": ["--topk_method", "approx"],
    "num_blocks": ["--num_blocks", "2"],
    "aggregate": ["--mode", "local_topk", "--aggregate", "sparse"],
    "overlap_collectives": ["--overlap_collectives", "layerwise"],
    "fsdp": ["--fsdp", "true"],
    "pipeline_depth": ["--pipeline_depth", "2"],
    "label_noise": ["--label_noise", "0.1"],
    "num_classes": ["--num_classes", "5"],
    "device_data": ["--device_data", "false"],
    "device_data_max_mb": ["--device_data_max_mb", "1024"],
    "sketch_fused_bwd": ["--mode", "sketch", "--fuse_clients", "true",
                         "--sketch_fused_bwd", "true"],
    "availability": ["--availability", "bernoulli", "--dropout_prob", "0.3"],
    "dropout_prob": ["--availability", "sine", "--dropout_prob", "0.5"],
    "availability_period": ["--availability", "sine",
                            "--availability_period", "8"],
    "num_cohorts": ["--availability", "cohort", "--num_cohorts", "2"],
    "arrival_rate": ["--availability", "poisson", "--arrival_rate", "2.0"],
    "chaos": ["--chaos", "dropout@0.2,straggler@0.1,nan_client@3"],
    "dp_noise_multiplier": ["--max_grad_norm", "1.0",
                            "--dp_noise_multiplier", "0.5"],
    "checkpoint_every": ["--checkpoint_dir", "ck", "--checkpoint_every", "2"],
    "checkpoint_dir": ["--checkpoint_dir", "ck"],
    "resume": ["--checkpoint_dir", "ck", "--resume", "true"],
    "telemetry_level": ["--telemetry_level", "2"],
    "flight_window": ["--telemetry_level", "1", "--flight_window", "4"],
    "logdir": ["--logdir", "elsewhere"],
    "tensorboard": ["--tensorboard", "true"],
    "profile_dir": ["--profile_dir", "prof"],
    "perf_audit": ["--perf_audit", "false"],
    "run_report": ["--run_report", "false"],
    "profile_rounds": ["--profile_rounds", "3-4"],
    "control_policy": ["--mode", "true_topk", "--control_policy",
                       "budget_pacing", "--budget_mb", "1.0"],
    "budget_mb": ["--mode", "true_topk", "--control_policy", "fixed",
                  "--control_schedule", "0-=0", "--budget_mb", "2.5"],
    "ladder": ["--mode", "true_topk", "--control_policy", "fixed",
               "--control_schedule", "0-=1", "--ladder", "k=10,5"],
    "control_schedule": ["--mode", "true_topk", "--control_policy", "fixed",
                         "--control_schedule", "0-=0"],
    "control_ef_up": _EF + ["--control_ef_up", "0.3"],
    "control_ef_down": _EF + ["--control_ef_down", "-0.1"],
    "control_fidelity_max": _EF + ["--control_fidelity_max", "0.5"],
    "control_hysteresis": _EF + ["--control_hysteresis", "4"],
    "recover_policy": ["--telemetry_level", "1", "--recover_policy",
                       "retry"],
    "snapshot_every": ["--snapshot_every", "4"],
    "max_recoveries": ["--max_recoveries", "3"],
    "preempt_signals": ["--preempt_signals", "true"],
    "client_store": ["--mode", "local_topk", "--error_type", "local",
                     "--client_store", "host"],
    "client_store_cache_rows": ["--client_store", "host",
                                "--client_store_cache_rows", "4"],
    "client_store_path": ["--client_store", "mmap", "--client_store_path",
                          "bank"],
    "offload_client_state": ["--offload_client_state", "true"],
    "async_buffer": ["--async_buffer", "2"],
    "async_concurrency": ["--async_buffer", "2", "--async_concurrency", "3"],
    "staleness_exponent": ["--async_buffer", "2", "--staleness_exponent",
                           "0.5"],
    "async_double_buffer": ["--async_buffer", "2", "--async_double_buffer",
                            "true"],
    "control_staleness_hi": _SA + ["--control_staleness_hi", "3.0"],
    "control_staleness_lo": _SA + ["--control_staleness_lo", "0.1"],
    "control_fill_hi": _SA + ["--control_fill_hi", "2.0"],
    "control_fill_lo": _SA + ["--control_fill_lo", "0.1"],
}


@pytest.mark.parametrize("field", sorted(LIFTED))
def test_config_accepts_the_lifted_fields(field):
    from commefficient_tpu.utils.config import Config as Ref

    cfg = parse_args(LIFTED[field] + ["--num_workers", "2", "--num_clients",
                                      "4"])
    assert getattr(cfg, field) != getattr(Config(), field)
    assert field not in _UNPORTED
    ref = Ref(**{k: getattr(cfg, k) for k in Ref.__dataclass_fields__})
    assert getattr(ref, field) == getattr(cfg, field)
    assert ref.fedsim_enabled == cfg.fedsim_enabled


# each of the reference's refusals of aggregate (its utils/config.py):
# (flags over local_topk's, the port's message, the reference's)
AGGREGATE_REFUSALS = {
    "value": (["--aggregate", "bogus"], "auto|dense|sparse"),
    "dense_mode": (["--mode", "uncompressed", "--aggregate", "sparse"],
                   "no sparse transmit"),
    "fsdp": (["--mode", "true_topk", "--topk_method", "threshold",
              "--aggregate", "sparse", "--fsdp", "true"], "FSDP round"),
    "true_topk_exact": (["--mode", "true_topk", "--aggregate", "sparse"],
                        "topk_method='threshold'"),
    "sketch_exact": (["--mode", "sketch", "--aggregate", "sparse"],
                     "topk_method='threshold'"),
    "sketch_dense_decode": (["--mode", "sketch", "--topk_method",
                             "threshold", "--sketch_decode", "dense",
                             "--aggregate", "sparse"], "sharded server decode"),
}


@pytest.mark.parametrize("name", sorted(AGGREGATE_REFUSALS))
def test_config_refuses_what_the_reference_refuses_of_aggregate(name):
    from commefficient_tpu.utils.config import Config as Ref

    flags, match = AGGREGATE_REFUSALS[name]
    argv = ["--mode", "local_topk", "--num_workers", "2", "--num_clients",
            "4"] + flags
    with pytest.raises(ValueError, match=match) as port:
        parse_args(argv)
    kw = {}
    for flag, value in zip(argv[::2], argv[1::2]):
        field = flag[2:]
        default = Ref.__dataclass_fields__[field].default
        kw[field] = (value.lower() == "true" if isinstance(default, bool)
                     else type(default)(value))
    with pytest.raises(ValueError) as ref:
        Ref(**kw)
    assert "aggregate" in str(port.value) and "aggregate" in str(ref.value)


def test_every_remaining_refusal_names_its_roadmap_item():
    assert len(_UNPORTED) == 7
    for name, blocker in _UNPORTED.items():
        assert "ROADMAP A" in blocker, name


@pytest.mark.parametrize("model", ["resnet9", "fixup_resnet50", "resnet50"])
@pytest.mark.parametrize("dataset", ["cifar10", "cifar100", "femnist",
                                     "imagenet"])
def test_cv_models_take_every_cv_dataset(model, dataset):
    cfg = parse_args(["--model", model, "--dataset_name", dataset])
    assert (cfg.model, cfg.dataset_name) == (model, dataset)


def test_gpt2_keeps_personachat():
    parse_args(["--model", "gpt2", "--dataset_name", "personachat"])
    for model, dataset in (("gpt2", "femnist"), ("gpt2_tiny", "cifar10"),
                           ("resnet9", "personachat"),
                           ("fixup_resnet50", "mnist")):
        with pytest.raises(ValueError, match="dataset_name"):
            parse_args(["--model", model, "--dataset_name", dataset])
    with pytest.raises(ValueError, match="model must be one of"):
        parse_args(["--model", "resnet18"])


def test_config_flags_and_defaults_follow_reference():
    from commefficient_tpu.utils.config import Config as Ref

    ref_fields = {f: getattr(Ref(), f) for f in Ref.__dataclass_fields__}
    for name in Config.__dataclass_fields__:
        if name in ("device", "max_rounds"):
            continue  # the port's own
        assert getattr(Config(), name) == ref_fields[name], name
    # and the other way round: every reference field exists in the port,
    # under its name, type and default, so a reference command line parses
    for name, field in Ref.__dataclass_fields__.items():
        assert name in Config.__dataclass_fields__, name
        assert str(Config.__dataclass_fields__[name].type) == str(
            field.type), name
    cfg = parse_args(["--mode", "sketch", "--k", "7", "--virtual_momentum",
                      "0.9", "--error_type", "virtual", "--sketch_backend",
                      "pallas", "--max_grad_norm", "none", "--device", "cpu"])
    assert (cfg.mode, cfg.k, cfg.sketch_backend, cfg.max_grad_norm,
            cfg.device) == ("sketch", 7, "pallas", None, "cpu")


def _wide_params():
    """tests/test_round.py's ``Wide`` (Dense(8192) -> Dense(4) on 256
    inputs, d ~ 2.1M): realized sketch widths track the request."""
    z = np.zeros
    return {"params": {
        "Dense_0": {"bias": z(8192, np.float32),
                    "kernel": z((256, 8192), np.float32)},
        "Dense_1": {"bias": z(4, np.float32),
                    "kernel": z((8192, 4), np.float32)}}}


def _envelope_warnings(**cfg_kw):
    import warnings as _w

    kw = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=16, num_rows=3, **{**BASE, "num_devices": 1}, device="cpu")
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        FederatedSession(Config(**{**kw, **cfg_kw}), _wide_params(),
                         classification_loss(torch_tinymlp))
    return [str(x.message) for x in rec if "envelope" in str(x.message)]


def test_envelope_warning_suggestion_converges():
    """The d/c envelope warning's 'Raise num_cols to >=' advice clears the
    realized-width check when followed (the reference's test)."""
    import re

    first = _envelope_warnings(num_cols=20_000)  # d/c ~ 100
    assert first, "expected the envelope warning to fire"
    suggest = int(re.search(r"Raise num_cols to >= ([\d,]+)", first[0])
                  .group(1).replace(",", ""))
    assert not _envelope_warnings(num_cols=suggest)


def test_envelope_warning_gamma_dependent():
    """error_decay widens the envelope: a d/c ~30 that warns undecayed
    passes at gamma 0.9 (the reference's test)."""
    from jax.flatten_util import ravel_pytree

    d = ravel_pytree(_wide_params())[0].size
    assert _envelope_warnings(num_cols=int(d / 30), error_decay=1.0)
    assert not _envelope_warnings(num_cols=int(d / 30), error_decay=0.9)


def test_envelope_matches_reference_and_brackets_gpt2_baseline():
    """The port's envelope is the reference's function for every gamma,
    and BASELINE #4 (GPT-2, D = 124,444,417, 5 rows) sits inside it at
    num_cols 5,000,000 (d/c 24.9 < 25) and outside at 4,900,000."""
    from commefficient_tpu.parallel import envelope as ref_env
    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.parallel import envelope
    from commefficient_tpu_torch.parallel.api import envelope_warning

    for g in (1.0, 0.95, 0.9, 0.85, 0.5, 0.0):
        assert envelope.stable_dc_bound(g) == ref_env.stable_dc_bound(g)
        assert envelope.predicted_dc_max(g) == ref_env.predicted_dc_max(g)
    D = 124_444_417
    spec = CountSketch(d=D, c=5_000_000, r=5)
    assert spec.c_actual == 5_000_688
    assert envelope_warning(D, spec.c_actual, 1.0) is None
    narrow = CountSketch(d=D, c=4_900_000, r=5).c_actual
    assert "OUTSIDE the stable envelope" in envelope_warning(D, narrow, 1.0)


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    from commefficient_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")


def _write_cifar_pickles(root, n_per_batch=8, seed=0):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        raw = {b"data": rng.integers(0, 256, size=(n_per_batch, 3072),
                                     dtype=np.uint8),
               b"labels": rng.integers(0, 10, size=n_per_batch).tolist()}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(raw, f)


# mode -> (its flags, its upload bytes per client per round)
SMOKE_MODES = {
    "sketch": (["--k", "5000", "--virtual_momentum", "0.9", "--error_type",
                "virtual", "--sketch_backend", "pallas",
                "--local_batch_size", "10"], 4 * 5 * 505_440),
    "local_topk": (["--k", "5000", "--error_type", "local",
                    "--local_momentum", "0.9", "--local_batch_size", "10"],
                   4 * 2 * 5000),
    # the sampler draws 2 x 5 a client: two local steps of 5
    "fedavg": (["--num_local_iters", "2", "--local_batch_size", "5"],
               4 * 6_573_130),
}


@pytest.mark.parametrize("mode", sorted(SMOKE_MODES))
def test_cv_train_main_smoke_on_cpu(tmp_path, mode):
    """Two full-width ResNet-9 rounds through the entry point a user
    calls, on the plain CPU path, reading a tiny CIFAR-10 pickle set (40
    training images: 2 rounds of 2 clients x 10)."""
    flags, upload_bytes = SMOKE_MODES[mode]
    _write_cifar_pickles(str(tmp_path))
    out = __import__("commefficient_tpu_torch.train.cv_train",
                     fromlist=["main"]).main([
        "--mode", mode, *flags, "--num_clients", "4", "--num_workers", "2",
        "--num_epochs", "1", "--compute_dtype", "float32",
        "--dataset_dir", str(tmp_path), "--device", "cpu"],
        eval_batch_size=8)
    assert out["grad_size"] == 6_573_130
    assert len(out["history"]) == 2
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    assert out["param_delta_norm"] > 0
    assert np.isfinite(out["loss"]) and 0.0 <= out["accuracy"] <= 1.0
    assert out["bytes_per_round"]["upload_bytes"] == upload_bytes

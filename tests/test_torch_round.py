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
from commefficient_tpu_torch.utils.config import Config, parse_args
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
    ("mode", "true_topk", "A7"),
    ("num_devices", "2", "A9"),
    ("sketch_decode", "sharded", "B4"),
    ("topk_method", "threshold", "A7"),
    ("num_blocks", "2", "A7"),
    ("sketch_table_dtype", "bfloat16", "A10"),
    ("sketch_fused_bwd", "true", "A10"),
    ("availability", "bernoulli", "A8"),
    ("telemetry_level", "1", "A12"),
    ("ladder", "k=10,5", "A11"),
])
def test_config_refuses_what_the_port_does_not_run(flag, value, item):
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        parse_args([f"--{flag}", value, "--num_workers", "2",
                    "--num_clients", "4"])


def test_config_flags_and_defaults_follow_reference():
    from commefficient_tpu.utils.config import Config as Ref

    ref_fields = {f: getattr(Ref(), f) for f in Ref.__dataclass_fields__}
    for name in Config.__dataclass_fields__:
        if name in ("device", "max_rounds"):
            continue  # the port's own
        assert getattr(Config(), name) == ref_fields[name], name
    cfg = parse_args(["--mode", "sketch", "--k", "7", "--virtual_momentum",
                      "0.9", "--error_type", "virtual", "--sketch_backend",
                      "pallas", "--max_grad_norm", "none", "--device", "cpu"])
    assert (cfg.mode, cfg.k, cfg.sketch_backend, cfg.max_grad_norm,
            cfg.device) == ("sketch", 7, "pallas", None, "cpu")


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


@pytest.mark.parametrize("mode", ["sketch"])
def test_cv_train_main_smoke_on_cpu(tmp_path, mode):
    """Two full-width ResNet-9 FetchSGD rounds through the entry point a
    user calls, on the plain CPU path, reading a tiny CIFAR-10 pickle set
    (40 training images: 2 rounds of 2 clients x 10)."""
    _write_cifar_pickles(str(tmp_path))
    out = __import__("commefficient_tpu_torch.train.cv_train",
                     fromlist=["main"]).main([
        "--mode", mode, "--k", "5000", "--virtual_momentum", "0.9",
        "--error_type", "virtual", "--sketch_backend", "pallas",
        "--num_clients", "4", "--num_workers", "2", "--local_batch_size",
        "10", "--num_epochs", "1", "--compute_dtype", "float32",
        "--dataset_dir", str(tmp_path), "--device", "cpu"],
        eval_batch_size=8)
    assert out["grad_size"] == 6_573_130
    assert len(out["history"]) == 2
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    assert out["param_delta_norm"] > 0
    assert np.isfinite(out["loss"]) and 0.0 <= out["accuracy"] <= 1.0
    assert out["bytes_per_round"]["upload_bytes"] == 4 * 5 * 505_440

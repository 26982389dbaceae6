"""The port's device-resident training set on the CPU: the index round
against the batch round, the gate, and the new datasets through
``cv_train.main``.

``FederatedSession.train_round_indices`` gathers the round's rows from the
attached training set, runs the augment's ``device_apply`` and then the
round ``train_round`` runs, so with the sampler's identical draws the two
paths must train identically: losses and params bit-equal after three
rounds (tests/test_device_data.py's check of the reference, here for the
port's uncompressed, sketch and fedavg rounds, with and without the CIFAR
augment and with ImageNet's RRC). Here "the device" is the CPU tensor the
session lives on; the card runs the same code (``chip_smoke.py``'s
``device_data`` phase).
"""

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.data import (
    CifarAugment,
    FedDataset,
    FedSampler,
    ImageNetAugment,
)
from commefficient_tpu_torch.models.losses import softmax_cross_entropy
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.train import cv_train
from commefficient_tpu_torch.utils.config import Config

ROUNDS = 3


def _toy_ds(n=256, num_clients=8, seed=0, uint8=True, size=32):
    rng = np.random.default_rng(seed)
    if uint8:
        x = rng.integers(0, 256, size=(n, size, size, 3)).astype(np.uint8)
    else:
        x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return FedDataset({"x": x, "y": y}, num_clients, seed=seed)


def _linear(size=32):
    """A linear model over flattened pixels (the reference test's)."""

    def loss_fn(params, batch):
        x = batch["x"].to(torch.float32).reshape(batch["x"].shape[0], -1)
        logits = x @ params["w"] + params["b"]
        y = batch["y"]
        correct = torch.sum(torch.argmax(logits, -1) == y).to(torch.float32)
        return softmax_cross_entropy(logits, y), {
            "correct": correct, "count": torch.tensor(float(y.numel()))}

    params = {"w": np.zeros((size * size * 3, 10), np.float32),
              "b": np.zeros((10,), np.float32)}
    return params, loss_fn


def _run_paths(cfg, ds, augment, size=32):
    """(losses, final params) of ROUNDS rounds by the batch path and by the
    index path."""
    params, loss_fn = _linear(size)
    out = []
    for on_device in (False, True):
        session = FederatedSession(cfg, params, loss_fn)
        sampler = FedSampler(ds, num_workers=cfg.num_workers,
                             local_batch_size=cfg.sampler_batch_size,
                             seed=cfg.seed, augment=augment)
        if on_device:
            assert session.maybe_attach_data(ds, sampler, augment)
            assert session.data_path == "device"
        else:
            assert session.data_path == "host"
        losses = []
        for r in range(ROUNDS):
            lr = 0.1 + 0.05 * r
            if on_device:
                m = session.train_round_indices(
                    *sampler.sample_round_indices(r), lr)
            else:
                ids, batch = sampler.sample_round(r)
                m = session.train_round(ids, microbatched(cfg, batch), lr)
            losses.append(float(m["loss"]))
        out.append((losses, session.state.params_vec.clone()))
    return out


BASE = dict(num_clients=8, num_workers=4, num_devices=1, local_batch_size=8,
            weight_decay=0.0, seed=7, device="cpu")
CASES = {
    "uncompressed_fused": dict(mode="uncompressed", fuse_clients=True),
    "uncompressed_momentum": dict(mode="uncompressed", virtual_momentum=0.9),
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=64, num_rows=3, num_cols=2048, topk_method="threshold"),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=64),
    "fedavg_L1": dict(mode="fedavg", num_local_iters=1),
    "fedavg_L2": dict(mode="fedavg", num_local_iters=2),
}


@pytest.mark.parametrize("augment", ["cifar", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_index_round_bit_equals_batch_round(case, augment):
    cfg = Config(**BASE, **CASES[case])
    aug = CifarAugment() if augment == "cifar" else None
    (l_host, p_host), (l_dev, p_dev) = _run_paths(cfg, _toy_ds(), aug)
    assert l_dev == l_host
    assert torch.equal(p_dev, p_host)
    assert not torch.equal(p_host, torch.zeros_like(p_host))


@pytest.mark.parametrize("uint8", [True, False])
def test_index_round_with_rrc_matches_batch_round(uint8):
    """ImageNet's RRC on the index path: on the CPU the torch lerp is the
    numpy one, so the two paths agree bit for bit here too."""
    cfg = Config(**BASE, mode="fedavg", num_local_iters=2)
    ds = _toy_ds(uint8=uint8, size=16)
    (l_host, p_host), (l_dev, p_dev) = _run_paths(cfg, ds, ImageNetAugment(),
                                                  size=16)
    assert l_dev == l_host and torch.equal(p_dev, p_host)


def _gate(ds, **cfg_kw):
    params, loss_fn = _linear()
    session = FederatedSession(Config(**{**BASE, **cfg_kw}), params, loss_fn)
    sampler = FedSampler(ds, num_workers=4, local_batch_size=8,
                         augment=CifarAugment())
    return session.maybe_attach_data(ds, sampler, CifarAugment()), session


def test_gate_is_the_references():
    """On at the default; off with --device_data false and when the
    training set is over device_data_max_mb (MB of 1e6 bytes); uint8 kept
    uint8 on the device."""
    ds = _toy_ds(n=2000)  # 6,144,000 B of images + 8,000 B of labels
    on, session = _gate(ds)
    assert on and session.data_path == "device"
    assert session.dev_data["x"].dtype == torch.uint8
    assert session.dev_data["y"].dtype == torch.int32
    assert not _gate(ds, device_data=False)[0]
    assert not _gate(ds, device_data_max_mb=6)[0]
    assert _gate(ds, device_data_max_mb=7)[0]
    # a sampler that cannot fuse (float64 images under a plan) stays home
    f64 = FedDataset({"x": ds.data["x"].astype(np.float64),
                      "y": ds.data["y"]}, 8)
    assert not _gate(f64)[0]


def test_index_round_needs_attached_data():
    params, loss_fn = _linear()
    session = FederatedSession(Config(**BASE), params, loss_fn)
    with pytest.raises(ValueError, match="attach_data"):
        session.train_round_indices(np.arange(4), np.zeros((4, 8), np.int32),
                                    (), 0.1)


def _cv(tmp_path, flags, **model_kw):
    return cv_train.main(flags + [
        "--num_clients", "4", "--num_workers", "2", "--num_epochs", "1",
        "--max_rounds", "2", "--compute_dtype", "float32",
        "--dataset_dir", str(tmp_path), "--device", "cpu"],
        eval_batch_size=16, model_kw=model_kw)


def _assert_trained(out, d, data_path):
    assert out["grad_size"] == d
    assert out["data_path"] == data_path
    assert len(out["history"]) == 2
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    assert np.isfinite(out["loss"]) and out["param_delta_norm"] > 0


def test_cv_train_femnist_local_topk_on_device_data(tmp_path, capsys):
    """BASELINE #3's flags, tiny: the FEMNIST stand-in on the device."""
    out = _cv(tmp_path, ["--dataset_name", "femnist", "--mode", "local_topk",
                         "--error_type", "local", "--local_momentum", "0.9",
                         "--k", "500", "--local_batch_size", "8"], width=4)
    _assert_trained(out, 27_994, "device")
    assert "data=device" in capsys.readouterr().out
    assert out["bytes_per_round"]["upload_bytes"] == 4 * 2 * 500


def test_cv_train_imagenet_fixup_from_npy_cache(tmp_path, capsys):
    """BASELINE #5's flags, tiny: the small FixupResNet from a 64-image
    uint8 cache, 10 classes (the labels below the head's size); then the
    same with --device_data false on the host path."""
    rng = np.random.default_rng(3)
    root = tmp_path / "imagenet"
    root.mkdir()
    np.save(root / "imagenet_x.npy",
            rng.integers(0, 256, size=(64, 32, 32, 3)).astype(np.uint8))
    np.save(root / "imagenet_y.npy",
            rng.integers(0, 10, size=(64,)).astype(np.int32))
    flags = ["--dataset_name", "imagenet", "--model", "fixup_resnet50",
             "--mode", "fedavg", "--num_local_iters", "2", "--num_classes",
             "10", "--local_batch_size", "4"]
    small = dict(stage_sizes=(1, 1, 1, 1), width=8)
    dev = _cv(tmp_path, flags, **small)
    _assert_trained(dev, 128_576, "device")
    assert "data=device" in capsys.readouterr().out
    host = _cv(tmp_path, flags + ["--device_data", "false"], **small)
    _assert_trained(host, 128_576, "host")
    assert "data=host" in capsys.readouterr().out
    assert [r["loss"] for r in host["history"]] == [
        r["loss"] for r in dev["history"]]


def test_cv_train_cifar100(tmp_path):
    out = _cv(tmp_path, ["--dataset_name", "cifar100", "--mode",
                         "uncompressed", "--local_batch_size", "4"], width=4)
    # ResNet-9 at width 4: 26,350 with 10 classes, and 90 more classes of
    # a 32-wide head (kernel and bias)
    _assert_trained(out, 26_350 + 90 * 32 + 90, "device")


def test_config_resolves_classes_and_checks_the_new_knobs():
    for name, want in (("cifar10", 10), ("cifar100", 100), ("femnist", 62),
                       ("imagenet", 1000)):
        assert Config(dataset_name=name).resolved_num_classes == want
    assert Config(dataset_name="imagenet",
                  num_classes=10).resolved_num_classes == 10
    for bad in (dict(label_noise=1.5), dict(label_noise=-0.1),
                dict(num_classes=0), dict(device_data_max_mb=-1)):
        with pytest.raises(ValueError):
            Config(**bad)

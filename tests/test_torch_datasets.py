"""The port's other datasets (CIFAR-100, FEMNIST, ImageNet), its RRC
augment and the sampler's index form against the reference, on the CPU.

Draws, splits and client indices are held bit-equal to the reference's for
the same seed; the augments' numpy paths bit-equal; the device forms (torch
ops, here on the CPU) bit-equal for CIFAR's pure index and select ops, and
for ImageNet's bilinear RRC within 1 uint8 LSB (uint8 input) and 1e-5 of
the input's max (float32 input) of the numpy path and of the reference's
jnp ``device_apply``: the lerp ``a + (b - a) * t`` may be contracted into a
fused multiply-add on a device.
"""

import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.data import FedDataset as RefDataset
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.data import cifar as ref_cifar
from commefficient_tpu.data import emnist as ref_emnist
from commefficient_tpu.data import imagenet as ref_imagenet
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.data import cifar as port_cifar
from commefficient_tpu_torch.data import emnist as port_emnist
from commefficient_tpu_torch.data import imagenet as port_imagenet
from commefficient_tpu_torch.models import resnet9_apply
from test_torch_compressors import _assert_state_twin
from test_torch_fixup_resnet import TWIN, model_twin, perturbed


def _assert_split_equal(port_ds, ref_ds):
    assert port_ds.num_clients == ref_ds.num_clients
    assert port_ds.data.keys() == ref_ds.data.keys()
    for k in ref_ds.data:
        np.testing.assert_array_equal(port_ds.data[k], ref_ds.data[k])
        assert port_ds.data[k].dtype == ref_ds.data[k].dtype
    for a, b in zip(port_ds.client_indices, ref_ds.client_indices):
        np.testing.assert_array_equal(a, b)


def _assert_loaded_equal(port, ref):
    """(train, test, real) triples of both packages' loaders."""
    assert port[2] == ref[2]
    _assert_split_equal(port[0], ref[0])
    _assert_split_equal(port[1], ref[1])


def test_cifar100_stand_in_and_split_equal_reference(tmp_path):
    kw = dict(num_clients=5, iid=False, seed=3)
    port = port_cifar.load_fed_cifar100(str(tmp_path), **kw)
    ref = ref_cifar.load_fed_cifar100(str(tmp_path), **kw)
    _assert_loaded_equal(port, ref)
    assert not port[2] and int(port[0].data["y"].max()) == 99


def test_cifar100_pickles_read_like_reference(tmp_path):
    d = tmp_path / "cifar-100-python"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name, n in (("train", 30), ("test", 10)):
        raw = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
               b"fine_labels": rng.integers(0, 100, n).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(raw, f)
    kw = dict(num_clients=3, seed=1)
    port = port_cifar.load_fed_cifar100(str(tmp_path), **kw)
    _assert_loaded_equal(port, ref_cifar.load_fed_cifar100(str(tmp_path),
                                                           **kw))
    assert port[2] and port[0].data["x"].shape == (30, 32, 32, 3)


@pytest.mark.parametrize("label_noise", [0.0, 0.06])
def test_synthetic_femnist_draws_equal_reference(label_noise):
    a = port_emnist._synthetic_femnist(7, per_client=20, seed=5,
                                       label_noise=label_noise)
    b = ref_emnist._synthetic_femnist(7, per_client=20, seed=5,
                                      label_noise=label_noise)
    for k in b[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k])
        assert a[0][k].dtype == b[0][k].dtype
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    assert port_emnist.NUM_CLASSES == ref_emnist.NUM_CLASSES == 62
    assert port_emnist.EMNIST_NOISE_STREAM == ref_emnist.EMNIST_NOISE_STREAM


def test_femnist_noise_is_its_own_stream():
    """label_noise changes labels only, from the separate stream: x is the
    same at every setting, and the noise-free draw is 0.0's."""
    clean, _ = port_emnist._synthetic_femnist(5, per_client=40, seed=2,
                                              label_noise=0.0)
    noisy, _ = port_emnist._synthetic_femnist(5, per_client=40, seed=2,
                                              label_noise=0.5)
    np.testing.assert_array_equal(clean["x"], noisy["x"])
    assert (clean["y"] != noisy["y"]).any()


def test_load_fed_emnist_split_equals_reference(tmp_path):
    kw = dict(num_clients=6, seed=4, label_noise=0.06)
    port = port_emnist.load_fed_emnist(str(tmp_path), **kw)
    _assert_loaded_equal(port, ref_emnist.load_fed_emnist(str(tmp_path),
                                                          **kw))
    train = port[0]
    assert train.num_clients == 6 and len(train) == 6 * 120
    assert all(len(ix) == 108 for ix in train.client_indices)
    assert len(port[1]) == 6 * 12


def test_leaf_json_read_like_reference(tmp_path):
    root = tmp_path / "femnist" / "train"
    root.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for shard, users in (("all_data_0.json", ["f0", "f1"]),
                         ("all_data_1.json", ["f2"])):
        blob = {"users": users, "user_data": {
            u: {"x": rng.random((n, 784)).round(3).tolist(),
                "y": rng.integers(0, 62, n).tolist()}
            for u, n in zip(users, (7, 11, 1))}}
        (root / shard).write_text(json.dumps(blob))
    port = port_emnist.load_fed_emnist(str(tmp_path), num_clients=99, seed=0)
    _assert_loaded_equal(port, ref_emnist.load_fed_emnist(
        str(tmp_path), num_clients=99, seed=0))
    assert port[2] and port[0].num_clients == 3


def test_synthetic_imagenet_draws_equal_reference():
    a = port_imagenet._synthetic_imagenet(num_classes=10, n=64, size=16)
    b = ref_imagenet._synthetic_imagenet(num_classes=10, n=64, size=16)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def _npy_cache(root, n=64, size=32, classes=10, seed=3):
    """tests/test_train_entry.py's 64-image uint8 cache."""
    rng = np.random.default_rng(seed)
    d = root / "imagenet"
    d.mkdir()
    np.save(d / "imagenet_x.npy",
            rng.integers(0, 256, size=(n, size, size, 3)).astype(np.uint8))
    np.save(d / "imagenet_y.npy",
            rng.integers(0, classes, size=(n,)).astype(np.int32))


@pytest.mark.parametrize("iid", [True, False])
def test_load_fed_imagenet_npy_cache_equals_reference(tmp_path, iid):
    _npy_cache(tmp_path)
    kw = dict(num_clients=4, iid=iid, seed=5, num_classes=10)
    port = port_imagenet.load_fed_imagenet(str(tmp_path), **kw)
    _assert_loaded_equal(port, ref_imagenet.load_fed_imagenet(
        str(tmp_path), **kw))
    assert port[2] and len(port[0]) == 60 and len(port[1]) == 4
    assert port[0].data["x"].dtype == np.uint8


def test_imagefolder_decode_equals_reference(tmp_path):
    """The PIL decode, cached to .npy on first read, as the reference's."""
    Image = pytest.importorskip("PIL.Image")

    for root in ("port", "ref"):
        rng = np.random.default_rng(0)  # the same images in both trees
        for wnid in ("n01", "n02"):
            d = tmp_path / root / "imagenet" / "train" / wnid
            d.mkdir(parents=True)
            for i in range(3):
                px = rng.integers(0, 256, (40 + 3 * i, 50, 3),
                                  dtype=np.uint8)
                Image.fromarray(px).save(d / f"img{i}.png")
    kw = dict(num_clients=2, seed=1, num_classes=2, max_per_class=2)
    with pytest.warns(UserWarning, match="SKIPPED"):
        port = port_imagenet.load_fed_imagenet(str(tmp_path / "port"), **kw)
    with pytest.warns(UserWarning, match="SKIPPED"):
        ref = ref_imagenet.load_fed_imagenet(str(tmp_path / "ref"), **kw)
    _assert_loaded_equal(port, ref)
    assert (tmp_path / "port" / "imagenet" / "imagenet_x.npy").exists()
    assert port[0].data["x"].shape[1:] == (64, 64, 3)


def _images(dtype, n=48, size=16, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32)


def test_rrc_plan_equals_reference_with_the_fallback():
    for (h, w), scale in (((16, 16), (0.08, 1.0)), ((12, 20), (0.08, 1.0)),
                          ((16, 16), (1.5, 2.0))):  # no attempt fits
        a = port_imagenet.ImageNetAugment(scale=scale).plan(
            np.random.default_rng(7), 64, h, w)
        b = ref_imagenet.ImageNetAugment(scale=scale).plan(
            np.random.default_rng(7), 64, h, w)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    # every box of the last plan is the full image (the fallback)
    assert (a.hs == 16).all() and (a.ws == 16).all()
    assert (a.ys == 0).all() and (a.xs == 0).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rrc_apply_equals_reference(dtype):
    x = _images(dtype)
    p = port_imagenet.ImageNetAugment().plan(np.random.default_rng(2),
                                             len(x), 16, 16)
    got = port_imagenet.ImageNetAugment().apply(x, p)
    want = ref_imagenet.ImageNetAugment().apply(x, p)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == dtype


def _rrc_tolerance(dtype, x):
    return 1.0 if dtype == np.uint8 else 1e-5 * float(np.abs(x).max())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rrc_device_apply_matches_numpy_and_reference(dtype):
    x = _images(dtype, n=64)
    aug = port_imagenet.ImageNetAugment()
    p = aug.plan(np.random.default_rng(4), len(x), 16, 16)
    want = aug.apply(x, p)
    got = aug.device_apply(torch.from_numpy(x),
                           *(torch.from_numpy(np.asarray(a)) for a in p))
    assert got.dtype == torch.from_numpy(want).dtype
    ref = np.asarray(ref_imagenet.ImageNetAugment().device_apply(
        jnp.asarray(x), *(jnp.asarray(a) for a in p)))
    tol = _rrc_tolerance(dtype, x)
    for other in (want, ref):
        err = np.abs(got.numpy().astype(np.float64) - other).max()
        assert err <= tol, err


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_cifar_device_apply_is_bit_equal(dtype):
    x = _images(dtype, n=40, size=32)
    aug = port_cifar.CifarAugment()
    p = aug.plan(np.random.default_rng(1), len(x))
    want = aug.apply(x.copy(), p)
    got = aug.device_apply(torch.from_numpy(x),
                           *(torch.from_numpy(np.asarray(a)) for a in p))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = ref_cifar.CifarAugment().device_apply(
        jnp.asarray(x), *(jnp.asarray(a) for a in p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# name -> (port augment, reference augment, its plan type, image size)
AUGMENTS = {"cifar": (port_cifar.CifarAugment, ref_cifar.CifarAugment,
                      port_cifar.AugmentPlan, 32),
            "imagenet": (port_imagenet.ImageNetAugment,
                         ref_imagenet.ImageNetAugment, port_imagenet.RRCPlan,
                         16),
            "none": (None, None, None, 16)}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_index_form_reproduces_the_batch(name):
    """``sample_round_indices``: the reference's indices and plan for the
    same draws, and the gather plus the plan's ``apply`` (numpy) and
    ``device_apply`` (torch) equal ``sample_round``'s batch."""
    port_aug, ref_aug, plan_type, size = AUGMENTS[name]
    rng = np.random.default_rng(0)
    data = {"x": rng.integers(0, 256, (60, size, size, 3)).astype(np.uint8),
            "y": rng.integers(0, 10, 60).astype(np.int32)}
    port = FedSampler(FedDataset(data, 6, iid=False, seed=1), num_workers=3,
                      local_batch_size=4, seed=2,
                      augment=port_aug() if port_aug else None)
    ref = RefSampler(RefDataset(data, 6, iid=False, seed=1), num_workers=3,
                     local_batch_size=4, seed=2,
                     augment=ref_aug() if ref_aug else None)
    assert port.fusable and ref.fusable
    for r in range(3):
        ids, idx, plan = port.sample_round_indices(r)
        r_ids, r_idx, r_plan = ref.sample_round_indices(r)
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_array_equal(idx, r_idx)
        assert idx.dtype == np.int32 and len(plan) == len(r_plan)
        for a, b in zip(plan, r_plan):
            np.testing.assert_array_equal(a, b)
        _, batch = port.sample_round(r)
        flat = idx.reshape(-1)
        x = data["x"][flat]
        dev = torch.from_numpy(x)
        if port_aug:
            x = port.augment.apply(x, plan_type(*plan))
            dev = port.augment.device_apply(
                dev, *(torch.from_numpy(np.asarray(a)) for a in plan))
        np.testing.assert_array_equal(x.reshape(batch["x"].shape),
                                      batch["x"])
        tol = 1 if name == "imagenet" else 0
        assert np.abs(dev.numpy().astype(np.int64).reshape(batch["x"].shape)
                      - batch["x"]).max() <= tol
        np.testing.assert_array_equal(data["y"][flat].reshape(3, 4),
                                      batch["y"])


def test_fusable_follows_the_reference():
    rng = np.random.default_rng(0)
    base = {"x": rng.integers(0, 256, (12, 8, 8, 3)).astype(np.uint8),
            "y": np.arange(12, dtype=np.int32)}
    cases = [(base, port_cifar.CifarAugment(), ref_cifar.CifarAugment()),
             (base, None, None),
             ({**base, "x": base["x"].astype(np.float64)},
              port_cifar.CifarAugment(), ref_cifar.CifarAugment()),
             ({**base, "x": base["x"].reshape(12, -1)}, None, None),
             ({**base, "x": base["x"].reshape(12, -1)},
              port_cifar.CifarAugment(), ref_cifar.CifarAugment())]
    for data, pa, ra in cases:
        port = FedSampler(FedDataset(data, 3), num_workers=2,
                          local_batch_size=2, augment=pa)
        ref = RefSampler(RefDataset(data, 3), num_workers=2,
                         local_batch_size=2, augment=ra)
        assert port.fusable == ref.fusable


def test_index_form_refuses_int32_overflow(monkeypatch):
    ds = FedDataset({"x": np.zeros((4, 2), np.float32),
                     "y": np.zeros(4, np.int32)}, 2)
    s = FedSampler(ds, num_workers=1, local_batch_size=2)
    monkeypatch.setattr(FedDataset, "__len__", lambda self: 2**31)
    with pytest.raises(OverflowError, match="int32"):
        s.sample_round_indices(0)


def _resnet9_twin(kw, dataset, num_classes, channels, prep=None,
                  port_prep=None):
    from commefficient_tpu.models.resnet9 import ResNet9

    model = ResNet9(num_classes=num_classes, width=4, dtype=jnp.float32)
    x0 = jnp.zeros((1,) + dataset.data["x"].shape[1:3] + (channels,))
    params = perturbed(jax.jit(model.init)(jax.random.key(0), x0), seed=2,
                       scale=0.02)
    want, got = model_twin(
        {**TWIN, **kw}, model.apply,
        functools.partial(resnet9_apply, dtype=torch.float32), params,
        dataset, prep=prep, port_prep=port_prep)
    _assert_state_twin(got, want)
    assert want["losses"][0] != want["losses"][-1]


def test_femnist_local_topk_twin_matches_reference(tmp_path):
    """BASELINE #3's configuration (local_topk, local error feedback and
    local momentum) on the FEMNIST stand-in's own non-IID clients, a
    width-4 ResNet-9 on one channel and 62 classes."""
    train, _, _ = ref_emnist.load_fed_emnist(str(tmp_path), num_clients=6,
                                             seed=3)
    _resnet9_twin(dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=500), train, 62, 1)


def test_cifar100_uncompressed_twin_matches_reference():
    """CIFAR-100's stand-in (uint8, normalized in the loss), 100 classes."""
    data, _ = ref_cifar._synthetic_cifar(100, n_train=96, n_test=8)
    _resnet9_twin(dict(mode="uncompressed", virtual_momentum=0.9),
                  RefDataset(data, TWIN["num_clients"], seed=0), 100, 3,
                  prep=ref_cifar.device_normalizer(ref_cifar.CIFAR10_MEAN,
                                                   ref_cifar.CIFAR10_STD),
                  port_prep=port_cifar.normalizer(port_cifar.CIFAR10_MEAN,
                                                  port_cifar.CIFAR10_STD))

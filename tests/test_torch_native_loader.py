"""The port's native batch assembly (``commefficient_tpu_torch/native``) and
the sampler's host path on the CPU.

The C++ gather and augment are bit-equal to the port's numpy path in
float32 and uint8: the CIFAR prep (copies and fills) and ImageNet's
random-resized-crop (float32 arithmetic in numpy's order, built without
contraction), also at the crop boxes' edges and written into a caller's
buffer. The port's sampler draws the reference's numpy batches for the same
seed; the port's RRC is held to the reference's own native ``gather_rrc``
within the reference's stated tolerance (it builds with ``-march=native``
and may contract a product and a sum: <= 1 uint8 LSB, rtol 1e-6 in
float32). The fused sampler's shapes and determinism, the numpy fallback
equal to the native path, and ``prefetch``'s order, exception and early
stop.
"""

import shutil
import threading
import time

import numpy as np
import pytest

from commefficient_tpu import native as ref_native
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.data.cifar import CifarAugment as RefCifarAugment
from commefficient_tpu.data.fed_dataset import FedDataset as RefDataset
from commefficient_tpu.data.imagenet import ImageNetAugment as RefRRC
from commefficient_tpu_torch import native
from commefficient_tpu_torch.data import (
    CifarAugment,
    FedDataset,
    FedSampler,
    ImageNetAugment,
    RRCPlan,
)
from commefficient_tpu_torch.data.sampler import prefetch

AUGMENTS = {"cifar": (CifarAugment, RefCifarAugment, 32),
            "rrc": (ImageNetAugment, RefRRC, 48)}


def _images(n, size, dtype, seed=0, std=60.0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8)
    return rng.normal(0, std, (n, size, size, 3)).astype(np.float32)


def test_native_builds_into_the_build_directory():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the numpy path runs")
    assert native.available(), native.build_error()
    assert native.build_error() is None
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert native.omp_threads() >= 1


def _edge_plan(n, size):
    """RRC boxes at the edges: 1 x 1, a full image, a strip at the last
    row and column, with and without the flip, then random ones."""
    p = ImageNetAugment().plan(np.random.default_rng(3), n, size, size)
    ys, xs, hs, ws = (np.array(a) for a in p[:4])
    flips = np.array(p.flips)
    edges = [(0, 0, 1, 1), (0, 0, size, size), (size - 1, 0, 1, size),
             (0, size - 1, size, 1), (size - 2, size - 3, 2, 3)]
    for i, (y, x, h, w) in enumerate(edges):
        ys[i], xs[i], hs[i], ws[i] = y, x, h, w
        flips[i] = bool(i % 2)
    return RRCPlan(ys, xs, hs, ws, flips)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("kind", sorted(AUGMENTS))
def test_gather_apply_bit_equals_numpy(kind, dtype):
    if not native.available():
        pytest.skip("no native library on this machine")
    aug_cls, _, size = AUGMENTS[kind]
    aug = aug_cls()
    data = _images(80, size, dtype)
    rng = np.random.default_rng(7)
    idx = rng.integers(0, len(data), 96)
    p = (_edge_plan(96, size) if kind == "rrc"
         else aug.plan(rng, 96, size, size))
    want = aug.apply(np.ascontiguousarray(data[idx]), p)
    got = aug.gather_apply(data, idx, p)
    assert got.dtype == data.dtype
    np.testing.assert_array_equal(got, want)
    out = np.empty_like(want)
    assert aug.gather_apply(data, idx, p, out=out) is out
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_gather_rows_bit_equals_numpy(dtype):
    if not native.available():
        pytest.skip("no native library on this machine")
    rng = np.random.default_rng(1)
    for shape in ((50,), (50, 7), (50, 4, 5)):
        data = (rng.normal(size=shape) * 100).astype(dtype)
        idx = rng.integers(0, 50, 33)
        np.testing.assert_array_equal(native.gather_rows(data, idx),
                                      data[idx])


def test_gather_refuses_bad_input():
    if not native.available():
        pytest.skip("no native library on this machine")
    data = _images(8, 32, "uint8")
    with pytest.raises(IndexError, match="out of range"):
        native.gather_rows(data, np.array([0, 8]))
    with pytest.raises(IndexError, match="out of range"):
        native.gather_augment(data, np.array([-1]))
    p = RRCPlan(*(np.array([v], np.int32) for v in (30, 0, 4, 4)),
                np.array([False]))
    with pytest.raises(IndexError, match="crop box"):
        native.gather_rrc(data, np.array([0]), p)
    with pytest.raises(ValueError, match="out must be"):
        native.gather_rows(data, np.array([0]),
                           out=np.empty((1, 32, 32, 3), np.float32))


def _datasets(kind, dtype, n=200):
    size = AUGMENTS[kind][2] if kind != "none" else 32
    rng = np.random.default_rng(5)
    data = {"x": _images(n, size, dtype), "y": rng.integers(
        0, 10, n).astype(np.int32)}
    return (FedDataset(data, 8, iid=True, seed=0),
            RefDataset(data, 8, iid=True, seed=0))


@pytest.mark.parametrize("kind,dtype", [("cifar", "uint8"),
                                        ("rrc", "float32"),
                                        ("rrc", "uint8"), ("none", "uint8")])
def test_sampler_draws_the_references_numpy_batches(monkeypatch, kind,
                                                    dtype):
    """The port's sampler (native where it builds) against the reference's
    sampler with its native library off (its numpy path), same seed."""
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_build_failed", True)
    ds, ref_ds = _datasets(kind, dtype)
    aug, ref_aug = ((None, None) if kind == "none"
                    else (AUGMENTS[kind][0](), AUGMENTS[kind][1]()))
    port = FedSampler(ds, num_workers=4, local_batch_size=6, seed=3,
                      augment=aug)
    ref = RefSampler(ref_ds, num_workers=4, local_batch_size=6, seed=3,
                     augment=ref_aug)
    for r in (0, 5):
        ids, batch = port.sample_round(r)
        ref_ids, ref_batch = ref.sample_round(r)
        np.testing.assert_array_equal(ids, ref_ids)
        assert sorted(batch) == sorted(ref_batch)
        for k in batch:
            assert batch[k].dtype == ref_batch[k].dtype
            np.testing.assert_array_equal(batch[k], ref_batch[k])


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_rrc_within_the_references_native_tolerance(dtype):
    """The port's RRC against the reference's own native ``gather_rrc``,
    held as the reference holds it to numpy (its tolerance is stated for
    its unit-normal float32 images: tests/test_imagenet_augment.py)."""
    if not (native.available() and ref_native.available()):
        pytest.skip("a native library did not build on this machine")
    data = _images(64, 48, dtype, std=1.0)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 64, 48)
    p = ImageNetAugment().plan(rng, 48, 48, 48)
    got = native.gather_rrc(data, idx, p)
    want = ref_native.gather_rrc(data, idx, p)
    if dtype == "uint8":
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["cifar", "rrc"])
def test_fused_sampler_shapes_determinism_and_fallback(kind, monkeypatch):
    ds, _ = _datasets(kind, "uint8")
    sampler = FedSampler(ds, num_workers=4, local_batch_size=8, seed=1,
                         augment=AUGMENTS[kind][0]())
    size = AUGMENTS[kind][2]
    ids, b = sampler.sample_round(5)
    assert b["x"].shape == (4, 8, size, size, 3) and b["x"].dtype == np.uint8
    assert b["y"].shape == (4, 8) and ids.dtype == np.int32
    ids2, b2 = sampler.sample_round(5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(b["x"], b2["x"])
    for w, cid in enumerate(ids):  # each row is from its client's shard
        assert set(b["y"][w].tolist()) <= set(
            ds.data["y"][ds.client_indices[cid]].tolist())
    bufs = {}

    def alloc(key, shape, dtype):
        bufs[key] = np.empty(shape, dtype)
        return bufs[key]

    _, b3 = sampler.sample_round(5, alloc=alloc)
    if native.available():  # the arrays are the caller's buffers
        assert np.shares_memory(b3["x"], bufs["x"])
    np.testing.assert_array_equal(b3["x"], b["x"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", "switched off by the test")
    ids4, b4 = sampler.sample_round(5, alloc=alloc)
    np.testing.assert_array_equal(ids4, ids)
    for k in b:
        np.testing.assert_array_equal(b4[k], b[k])


def test_prefetch_order_exception_and_early_stop():
    assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))

    def boom():
        yield 1
        raise ValueError("producer failed")

    it = prefetch(boom())
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = set(threading.enumerate())
    it = prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the consumer quits: the producer stops and is joined
    assert not [t for t in set(threading.enumerate()) - before
                if t.name == "sampler-prefetch"]
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n and n <= 3 + 2 + 1

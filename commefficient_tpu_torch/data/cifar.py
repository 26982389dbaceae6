"""FedCIFAR10 / FedCIFAR100 — the port's own copy of
``commefficient_tpu/data/cifar.py``.

* the ``cifar-10-batches-py`` and ``cifar-100-python`` pickle loaders;
* the ``flat`` and ``concentrated`` synthetic stand-ins used when the real
  data is absent (same numpy draws from the same seed as the reference);
* ``CifarAugment``'s numpy plan and apply: pad(4) + random crop + hflip +
  cutout(8), on uint8 images; ``gather_apply``, the gather and the apply
  fused in the native library (``commefficient_tpu_torch/native``); and
  ``device_apply``, the same plan as torch index and select ops on the
  device-resident training set (each bit-equal to ``apply``);
* the normalizer, here a torch op applied on the batch's device.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.data.fed_dataset import FedDataset

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _load_cifar10_batches(root: str):
    d = os.path.join(root, "cifar-10-batches-py")

    def read(fname):
        # the standard CIFAR-10 python pickles, read from the user's own
        # dataset_dir
        with open(os.path.join(d, fname), "rb") as f:
            raw = pickle.load(f, encoding="bytes")
        x = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(raw[b"labels"], np.int32)
        return x, y

    xs, ys = zip(*[read(f"data_batch_{i}") for i in range(1, 6)])
    xte, yte = read("test_batch")
    return ({"x": np.concatenate(xs), "y": np.concatenate(ys)},
            {"x": xte, "y": yte})


def _synthetic_cifar(num_classes: int, n_train: int = 50_000,
                     n_test: int = 10_000, seed: int = 0):
    """Class-conditional images: per-class mean pattern + noise (the
    reference's ``flat`` stand-in, draw for draw)."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 255, size=(num_classes, 32, 32, 3)).astype(
        np.float32)

    def make(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        noise = rng.normal(0, 64, size=(n, 32, 32, 3)).astype(np.float32)
        x = np.clip(protos[y] + noise, 0, 255).astype(np.uint8)
        return {"x": x, "y": y}

    return make(n_train), make(n_test)


def _pink_fields(rng: np.random.Generator, n: int, alpha: float = 1.8,
                 hw: int = 32) -> np.ndarray:
    """[n, hw, hw, 3] unit-std smooth random fields, 1/f^alpha spectrum."""
    fy = np.fft.fftfreq(hw)[:, None]
    fx = np.fft.fftfreq(hw)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = 1.0 / f ** alpha
    amp[0, 0] = 0.0
    spec = (rng.normal(size=(n, hw, hw, 3))
            + 1j * rng.normal(size=(n, hw, hw, 3))) * amp[None, :, :, None]
    img = np.real(np.fft.ifft2(spec, axes=(1, 2)))
    img /= img.std(axis=(1, 2, 3), keepdims=True) + 1e-8
    return img.astype(np.float32)


def _synthetic_cifar_concentrated(
    num_classes: int, n_train: int = 50_000, n_test: int = 10_000,
    seed: int = 0, *, bg_rank: int = 12, bg_scale: float = 5.0,
    patch: int = 12, patches_per_class: int = 3, class_scale: float = 42.0,
    amp_jitter: float = 0.35, jitter_px: int = 2, noise_scale: float = 10.0,
    label_noise: float = 0.06, patch_dropout: float = 0.1,
):
    """The reference's ``concentrated`` stand-in (low-rank smooth background
    + per-class texture patches + label noise), draw for draw; see the
    reference docstring for why its gradients concentrate like real
    CIFAR's."""
    rng = np.random.default_rng(seed)
    B = _pink_fields(rng, bg_rank)
    atoms = _pink_fields(rng, num_classes * patches_per_class, alpha=1.2)
    atoms = atoms.reshape(num_classes, patches_per_class, 32, 32, 3)
    pos = rng.integers(jitter_px, 32 - patch - jitter_px,
                       size=(num_classes, patches_per_class, 2))

    def make(n):
        y_true = rng.integers(0, num_classes, size=n).astype(np.int32)
        z = rng.normal(size=(n, bg_rank)).astype(np.float32)
        x = 128.0 + np.float32(bg_scale / np.sqrt(bg_rank)) * np.tensordot(
            z, B, axes=(1, 0))
        amps = (1.0 + amp_jitter * rng.normal(size=(n, patches_per_class))
                ).astype(np.float32)
        amps *= rng.random((n, patches_per_class)) >= patch_dropout
        dy = rng.integers(-jitter_px, jitter_px + 1,
                          size=(n, patches_per_class))
        dx = rng.integers(-jitter_px, jitter_px + 1,
                          size=(n, patches_per_class))
        for p in range(patches_per_class):
            a = atoms[y_true, p][:, :patch, :patch, :]
            ys = pos[y_true, p, 0] + dy[:, p]
            xs = pos[y_true, p, 1] + dx[:, p]
            iy = ys[:, None] + np.arange(patch)
            ix = xs[:, None] + np.arange(patch)
            x[np.arange(n)[:, None, None], iy[:, :, None], ix[:, None, :]] += (
                class_scale * amps[:, p, None, None, None] * a)
        x += np.float32(noise_scale) * rng.standard_normal(x.shape,
                                                           dtype=np.float32)
        y = y_true.copy()
        flip = rng.random(n) < label_noise
        y[flip] = rng.integers(0, num_classes,
                               size=int(flip.sum())).astype(np.int32)
        return {"x": np.clip(x, 0, 255).astype(np.uint8), "y": y}

    return make(n_train), make(n_test)


def _synthetic_by_variant(num_classes: int, variant: str):
    if variant == "concentrated":
        return _synthetic_cifar_concentrated(num_classes)
    if variant == "concentrated_v2":
        return _synthetic_cifar_concentrated(num_classes, bg_scale=30.0,
                                             patch_dropout=0.25)
    if variant == "flat":
        return _synthetic_cifar(num_classes)
    raise ValueError(f"unknown synthetic_variant {variant!r} "
                     "(flat|concentrated|concentrated_v2)")


def load_fed_cifar10(dataset_dir: str, *, num_clients: int, iid: bool = True,
                     seed: int = 42, num_classes: int = 10,
                     synthetic_variant: str = "flat",
                     ) -> Tuple[FedDataset, FedDataset, bool]:
    """(train FedDataset, test FedDataset, is_real_data)."""
    real = os.path.isdir(os.path.join(dataset_dir, "cifar-10-batches-py"))
    if real:
        train, test = _load_cifar10_batches(dataset_dir)
    else:
        train, test = _synthetic_by_variant(num_classes, synthetic_variant)
    tr = FedDataset(dict(train), num_clients, iid=iid, seed=seed)
    te = FedDataset(dict(test), 1, iid=True, seed=seed)
    return tr, te, real


def _load_cifar100(root: str):
    """The ``cifar-100-python`` pickle layout (train/test files, fine
    labels), read from the user's own dataset_dir."""
    d = os.path.join(root, "cifar-100-python")

    def read(fname):
        with open(os.path.join(d, fname), "rb") as f:
            raw = pickle.load(f, encoding="bytes")
        x = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.asarray(raw[b"fine_labels"], np.int32)
        return {"x": x, "y": y}

    return read("train"), read("test")


def load_fed_cifar100(dataset_dir: str, *, num_clients: int,
                      iid: bool = True, seed: int = 42,
                      ) -> Tuple[FedDataset, FedDataset, bool]:
    """FedCIFAR100: CIFAR-10's prep and augment, 100 fine labels; the
    ``flat`` stand-in at 100 classes when the pickles are absent."""
    real = os.path.isdir(os.path.join(dataset_dir, "cifar-100-python"))
    if real:
        train, test = _load_cifar100(dataset_dir)
    else:
        train, test = _synthetic_cifar(100)
    tr = FedDataset(dict(train), num_clients, iid=iid, seed=seed)
    te = FedDataset(dict(test), 1, iid=True, seed=seed)
    return tr, te, real


def normalizer(mean: np.ndarray, std: np.ndarray):
    """Input prep for ``classification_loss``: uint8 [B,H,W,C] ->
    normalized float32 on the batch's own device; float inputs pass
    through (the reference's ``device_normalizer``)."""

    def prep(x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.uint8:
            return x
        m = torch.as_tensor(mean, device=x.device)
        s = torch.as_tensor(std, device=x.device)
        return (x.to(torch.float32) / 255.0 - m) / s

    return prep


class AugmentPlan(NamedTuple):
    """Per-image augmentation draws."""

    ys: np.ndarray  # [n] crop offsets in padded coords, 0..2*pad
    xs: np.ndarray
    flips: np.ndarray  # [n] bool
    cys: np.ndarray  # [n] cutout centers
    cxs: np.ndarray


class CifarAugment:
    """pad(4) + random crop + hflip + cutout(8) on uint8 images; the
    cutout fill is the per-channel mean in byte space (the reference's
    cutout after normalization fills 0.0, i.e. the mean)."""

    pad = 4
    cut_half = 4

    def __init__(self, fill_uint8=None):
        if fill_uint8 is None:
            fill_uint8 = np.round(255.0 * CIFAR10_MEAN).astype(np.uint8)
        self.fill_uint8 = np.asarray(fill_uint8, np.uint8)

    def _fill(self, dtype, c: int) -> np.ndarray:
        if dtype == np.uint8:
            return np.broadcast_to(self.fill_uint8, (c,)).astype(np.uint8)
        return np.zeros((c,), dtype)

    def plan(self, rng: np.random.Generator, n: int, h: int = 32,
             w: int = 32) -> AugmentPlan:
        return AugmentPlan(
            ys=rng.integers(0, 2 * self.pad + 1, size=n),
            xs=rng.integers(0, 2 * self.pad + 1, size=n),
            flips=rng.random(n) < 0.5,
            cys=rng.integers(0, h, size=n),
            cxs=rng.integers(0, w, size=n),
        )

    def apply(self, x: np.ndarray, p: AugmentPlan) -> np.ndarray:
        """[n, h, w, c] -> augmented copy (crop, flip, then cutout)."""
        n, h, w, c = x.shape
        pad = self.pad
        padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                        mode="reflect")
        iy = p.ys[:, None] + np.arange(h)
        ix = p.xs[:, None] + np.arange(w)
        out = padded[np.arange(n)[:, None, None], iy[:, :, None],
                     ix[:, None, :]]
        out[p.flips] = out[p.flips, :, ::-1]
        ch = self.cut_half
        ymask = ((np.arange(h)[None, :] >= p.cys[:, None] - ch)
                 & (np.arange(h)[None, :] < p.cys[:, None] + ch))
        xmask = ((np.arange(w)[None, :] >= p.cxs[:, None] - ch)
                 & (np.arange(w)[None, :] < p.cxs[:, None] + ch))
        mask = ymask[:, :, None] & xmask[:, None, :]
        out[mask] = self._fill(out.dtype, c)
        return out

    def gather_apply(self, data: np.ndarray, idx: np.ndarray,
                     p: AugmentPlan, out=None):
        """``apply(data[idx], p)`` fused in the native library (bit-equal),
        written into ``out`` when given; None without the library (the
        sampler then gathers and applies in numpy)."""
        from commefficient_tpu_torch import native

        return native.gather_augment(
            data, idx, p, pad=self.pad, cut_half=self.cut_half,
            fill=self._fill(data.dtype, data.shape[-1]), out=out)

    def device_apply(self, x: torch.Tensor, *plan) -> torch.Tensor:
        """``apply`` as torch ops on ``x``'s device (the device-resident
        data path); ``plan`` is the ``AugmentPlan``'s arrays as tensors on
        that device."""
        return device_augment(
            x, *plan, pad=self.pad, cut_half=self.cut_half,
            fill=self._fill(np.dtype(str(x.dtype).split(".")[-1]),
                            x.shape[-1]))


augment_batch = CifarAugment()


def device_augment(x: torch.Tensor, ys, xs, flips, cys, cxs, *,
                   pad: int = 4, cut_half: int = 4, fill=None):
    """``CifarAugment.apply`` as torch ops: the crop of the reflect-padded
    image as one index gather, flip, cutout. Pure index and select ops, so
    the result is bit-equal to the numpy path on any dtype. ``x`` ``[n, h,
    w, c]``; plan tensors ``[n]``; ``fill`` the ``[c]`` cutout fill (None =
    0)."""
    n, h, w, c = x.shape
    dev = x.device
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)

    def reflect(i, size):  # a padded coordinate -> its source pixel
        i = i - pad
        i = torch.where(i < 0, -i, i)
        return torch.where(i >= size, 2 * (size - 1) - i, i)

    # the crop of the reflect-padded image as ONE gather of the source
    iy = reflect(ys.to(torch.int64)[:, None] + ar_h, h)
    ix = reflect(xs.to(torch.int64)[:, None] + ar_w, w)
    out = x[torch.arange(n, device=dev)[:, None, None], iy[:, :, None],
            ix[:, None, :]]
    out = torch.where(flips.to(torch.bool)[:, None, None, None],
                      out.flip(2), out)
    cys = cys.to(torch.int64)[:, None]
    cxs = cxs.to(torch.int64)[:, None]
    ymask = (ar_h[None, :] >= cys - cut_half) & (ar_h[None, :] < cys
                                                  + cut_half)
    xmask = (ar_w[None, :] >= cxs - cut_half) & (ar_w[None, :] < cxs
                                                  + cut_half)
    mask = ymask[:, :, None] & xmask[:, None, :]
    fill_v = (torch.zeros(c, dtype=x.dtype, device=dev) if fill is None
              else torch.as_tensor(np.broadcast_to(fill, (c,)).copy(),
                                   device=dev).to(x.dtype))
    return torch.where(mask[..., None], fill_v, out)

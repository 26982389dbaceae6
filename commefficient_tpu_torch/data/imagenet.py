"""FedImageNet — ImageNet for the FixupResNet runs, sharded over clients.
The port's own copy of ``commefficient_tpu/data/imagenet.py``, the same
numpy draws from the same seed.

Three sources, in order: a preprocessed ``.npy`` cache
(``dataset_dir/imagenet/imagenet_{x,y}.npy``, uint8 kept uint8); an
ImageFolder tree (``dataset_dir/imagenet/train/<wnid>/*.JPEG``) decoded
with PIL when PIL is installed, resized and center-cropped to ``size`` and
then written to the cache; a float32 synthetic stand-in at reduced
resolution.

``ImageNetAugment`` is the train-time random-resized-crop + horizontal
flip, split into a plan (the draws, torchvision's RRC sequence) and the
pixel work, which runs in numpy on the host (``apply``), fused with the
gather in the native library (``gather_apply``, bit-equal to ``apply``), or
as torch ops on the device-resident training set (``device_apply``). The
bilinear lerp is written ``a + (b - a) * t`` in float32 in all three, so
they agree to the last bit up to the order the device may fuse a product
and a sum in (the native library is built not to fuse them).
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.data.fed_dataset import FedDataset

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class RRCPlan(NamedTuple):
    """Per-image random-resized-crop draws: the crop box in source pixels
    and the horizontal flip."""

    ys: np.ndarray  # [n] int32 crop top
    xs: np.ndarray  # [n] int32 crop left
    hs: np.ndarray  # [n] int32 crop height (>= 1)
    ws: np.ndarray  # [n] int32 crop width (>= 1)
    flips: np.ndarray  # [n] bool


def _bilinear_grid(out_len: int, crop_len: np.ndarray):
    """Sampling coordinates for resizing a ``crop_len``-pixel axis to
    ``out_len`` pixels, the torch/PIL bilinear convention
    (align_corners=False): ``src = (dst + 0.5) * crop/out - 0.5``, clamped
    to the crop. (lo index, hi index, hi weight), each ``[n, out_len]``."""
    f32 = np.float32
    crop = crop_len[:, None].astype(f32)
    g = (np.arange(out_len, dtype=f32)[None, :] + f32(0.5)) * (
        crop / f32(out_len)) - f32(0.5)
    g = np.clip(g, f32(0.0), crop - f32(1.0))
    lo = np.floor(g).astype(np.int32)
    hi = np.minimum(lo + 1, crop_len[:, None] - 1)
    return lo, hi, (g - lo.astype(f32)).astype(f32)


def _rrc_pixels(x: np.ndarray, p: RRCPlan) -> np.ndarray:
    """Bilinear crop-resize ``[n, H, W, C]`` -> float32 of the same shape:
    each image's (ys, xs, hs, ws) box resized back to (H, W)."""
    n, H, W, _ = x.shape
    f32 = np.float32
    y0, y1, wy = _bilinear_grid(H, p.hs)
    x0, x1, wx = _bilinear_grid(W, p.ws)
    ay0, ay1 = p.ys[:, None] + y0, p.ys[:, None] + y1
    ax0, ax1 = p.xs[:, None] + x0, p.xs[:, None] + x1
    ii = np.arange(n)[:, None, None]
    p00 = x[ii, ay0[:, :, None], ax0[:, None, :]].astype(f32)
    p01 = x[ii, ay0[:, :, None], ax1[:, None, :]].astype(f32)
    p10 = x[ii, ay1[:, :, None], ax0[:, None, :]].astype(f32)
    p11 = x[ii, ay1[:, :, None], ax1[:, None, :]].astype(f32)
    wyE, wxE = wy[:, :, None, None], wx[:, None, :, None]
    top = p00 + (p01 - p00) * wxE
    bot = p10 + (p11 - p10) * wxE
    return top + (bot - top) * wyE


def _bilinear_grid_torch(out_len: int, crop_len: torch.Tensor):
    """``_bilinear_grid`` as torch ops on ``crop_len``'s device."""
    f32 = torch.float32
    crop = crop_len[:, None].to(f32)
    ar = torch.arange(out_len, dtype=f32, device=crop_len.device)[None, :]
    # a true division by a tensor: a CUDA division by a Python scalar is a
    # product with its reciprocal, which can round differently
    g = (ar + 0.5) * (crop / torch.full_like(crop, out_len)) - 0.5
    g = torch.minimum(torch.clamp(g, min=0.0), crop - 1.0)
    lo = torch.floor(g).to(torch.int64)
    hi = torch.minimum(lo + 1, crop_len[:, None].to(torch.int64) - 1)
    return lo, hi, g - lo.to(f32)


def _rrc_pixels_torch(x: torch.Tensor, ys, xs, hs, ws) -> torch.Tensor:
    """``_rrc_pixels`` as torch ops on ``x``'s device."""
    n, H, W, _ = x.shape
    f32 = torch.float32
    y0, y1, wy = _bilinear_grid_torch(H, hs)
    x0, x1, wx = _bilinear_grid_torch(W, ws)
    ys = ys.to(torch.int64)[:, None]
    xs = xs.to(torch.int64)[:, None]
    ay0, ay1 = ys + y0, ys + y1
    ax0, ax1 = xs + x0, xs + x1
    ii = torch.arange(n, device=x.device)[:, None, None]
    p00 = x[ii, ay0[:, :, None], ax0[:, None, :]].to(f32)
    p01 = x[ii, ay0[:, :, None], ax1[:, None, :]].to(f32)
    p10 = x[ii, ay1[:, :, None], ax0[:, None, :]].to(f32)
    p11 = x[ii, ay1[:, :, None], ax1[:, None, :]].to(f32)
    wyE, wxE = wy[:, :, None, None], wx[:, None, :, None]
    top = p00 + (p01 - p00) * wxE
    bot = p10 + (p11 - p10) * wxE
    return top + (bot - top) * wyE


class ImageNetAugment:
    """Random-resized-crop + horizontal flip (torchvision's
    ``RandomResizedCrop`` + ``RandomHorizontalFlip``), plan-based.

    The plan follows torchvision's RRC: ``attempts`` tries, each drawing an
    area fraction ~ U(scale) and an aspect ~ exp(U(log ratio)); the first
    whose integer box fits wins, the draws of the attempts that lose are
    consumed all the same, and with none fitting the box is the full image
    (torchvision's fallback for a square source). The crop is resized back
    to the source (H, W) bilinearly, then flipped with p = 0.5. The source
    is the size x size decode cache, so scale fractions are relative to
    it."""

    def __init__(self, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 attempts: int = 10):
        self.scale = scale
        self.ratio = ratio
        self.attempts = attempts

    def plan(self, rng: np.random.Generator, n: int, h: int,
             w: int) -> RRCPlan:
        T = self.attempts
        area = h * w * rng.uniform(self.scale[0], self.scale[1], size=(n, T))
        aspect = np.exp(rng.uniform(np.log(self.ratio[0]),
                                    np.log(self.ratio[1]), size=(n, T)))
        ws = np.round(np.sqrt(area * aspect)).astype(np.int64)
        hs = np.round(np.sqrt(area / aspect)).astype(np.int64)
        uy = rng.random((n, T))
        ux = rng.random((n, T))
        valid = (ws > 0) & (ws <= w) & (hs > 0) & (hs <= h)
        first = np.argmax(valid, axis=1)  # the first that fits; 0 if none
        rows = np.arange(n)
        any_valid = valid[rows, first]
        hs_f = hs[rows, first]
        ws_f = ws[rows, first]
        ys_f = np.floor(uy[rows, first] * (h - hs_f + 1)).astype(np.int64)
        xs_f = np.floor(ux[rows, first] * (w - ws_f + 1)).astype(np.int64)
        return RRCPlan(
            ys=np.where(any_valid, ys_f, 0).astype(np.int32),
            xs=np.where(any_valid, xs_f, 0).astype(np.int32),
            hs=np.where(any_valid, hs_f, h).astype(np.int32),
            ws=np.where(any_valid, ws_f, w).astype(np.int32),
            flips=rng.random(n) < 0.5,
        )

    def apply(self, x: np.ndarray, p: RRCPlan) -> np.ndarray:
        """[n, h, w, c] -> augmented copy (numpy, on the host)."""
        val = _rrc_pixels(x, p)
        if x.dtype == np.uint8:
            out = np.clip(np.rint(val), 0, 255).astype(np.uint8)
        else:
            out = val.astype(x.dtype)
        out[p.flips] = out[p.flips, :, ::-1]
        return out

    def gather_apply(self, data: np.ndarray, idx: np.ndarray, p: RRCPlan,
                     out=None):
        """``apply(data[idx], p)`` fused in the native library (bit-equal:
        the same float32 operations in the same order), written into
        ``out`` when given; None without the library (the sampler then
        gathers and applies in numpy)."""
        from commefficient_tpu_torch import native

        return native.gather_rrc(data, idx, p, out=out)

    def device_apply(self, x: torch.Tensor, *plan) -> torch.Tensor:
        """``apply`` as torch ops on ``x``'s device; ``plan`` is the
        ``RRCPlan``'s arrays as tensors on that device."""
        ys, xs, hs, ws, flips = plan
        val = _rrc_pixels_torch(x, ys, xs, hs, ws)
        if x.dtype == torch.uint8:
            out = torch.clamp(torch.round(val), 0, 255).to(torch.uint8)
        else:
            out = val.to(x.dtype)
        return torch.where(flips.to(torch.bool)[:, None, None, None],
                           out.flip(2), out)


def _load_imagefolder(train_root: str, size: int,
                      max_per_class: Optional[int] = None) -> Optional[dict]:
    """Decode an ImageFolder tree with PIL, or None without PIL: each image
    resized so its short side is ``size`` and center-cropped to ``size x
    size``, uint8, at most ``max_per_class`` a class (a warning names what
    was skipped)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    exts = (".jpeg", ".jpg", ".png")
    wnids = sorted(d for d in os.listdir(train_root)
                   if os.path.isdir(os.path.join(train_root, d)))
    xs, ys = [], []
    truncated = 0
    for label, wnid in enumerate(wnids):
        cdir = os.path.join(train_root, wnid)
        all_files = sorted(f for f in os.listdir(cdir)
                           if f.lower().endswith(exts))
        files = all_files[:max_per_class]
        truncated += len(all_files) - len(files)
        for fn in files:
            with Image.open(os.path.join(cdir, fn)) as im:
                im = im.convert("RGB")
                w, h = im.size
                scale = size / min(w, h)
                im = im.resize((round(w * scale), round(h * scale)))
                w, h = im.size
                left, top = (w - size) // 2, (h - size) // 2
                im = im.crop((left, top, left + size, top + size))
                xs.append(np.asarray(im, np.uint8))
            ys.append(label)
    if not xs:
        return None
    if truncated:
        warnings.warn(
            f"ImageFolder decode kept at most {max_per_class} images/class "
            f"({truncated} images SKIPPED); the .npy cache written from "
            "this decode is a SUBSET of the tree. Accuracy from this run "
            "is not full-ImageNet accuracy.", stacklevel=3)
    return {"x": np.stack(xs), "y": np.asarray(ys, np.int32)}


def _synthetic_imagenet(num_classes: int = 1000, n: int = 20_000,
                        size: int = 64, seed: int = 9):
    """Float32 class prototypes in [-1, 1] plus N(0, 0.5) noise."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, size=(num_classes, size, size, 3)).astype(
        np.float32)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0, 0.5, size=(n, size, size, 3)).astype(
        np.float32)
    return {"x": x.astype(np.float32), "y": y}


def load_fed_imagenet(dataset_dir: str, *, num_clients: int,
                      iid: bool = False, seed: int = 42,
                      num_classes: int = 1000, synthetic_size: int = 64,
                      max_per_class: int = 300,
                      ) -> Tuple[FedDataset, FedDataset, bool]:
    """(train, test, is_real): the ``.npy`` cache, else the ImageFolder
    tree (cached on first decode), else the stand-in; a seeded permutation,
    then the first 95% train and the rest test."""
    root = os.path.join(dataset_dir, "imagenet")
    xp = os.path.join(root, "imagenet_x.npy")
    yp = os.path.join(root, "imagenet_y.npy")
    real = os.path.exists(xp) and os.path.exists(yp)
    if real:
        data = {"x": np.load(xp), "y": np.load(yp)}
    else:
        train_root = os.path.join(root, "train")
        data = None
        if os.path.isdir(train_root):
            data = _load_imagefolder(train_root,
                                     size=max(synthetic_size, 64),
                                     max_per_class=max_per_class)
            if data is not None:
                real = True
                np.save(xp, data["x"])  # the decode happens once
                np.save(yp, data["y"])
        if data is None:
            data = _synthetic_imagenet(num_classes, size=synthetic_size,
                                       seed=seed)
    n = len(data["y"])
    # an ImageFolder decode is class-sorted: shuffle before the split
    perm = np.random.default_rng(seed).permutation(n)
    data = {k: v[perm] for k, v in data.items()}
    cut = int(0.95 * n)
    train = FedDataset({k: v[:cut] for k, v in data.items()}, num_clients,
                       iid=iid, seed=seed)
    test = FedDataset({k: v[cut:] for k, v in data.items()}, 1, iid=True,
                      seed=seed)
    return train, test, real

"""ResNet-9 as FetchSGD trains it (Page's cifar10-fast network with
GroupNorm for federated clients), plain PyTorch in float32: uint8 NHWC
images normalised by CIFAR-10's channel means and deviations, then a
prep block, a pooled block, a residual pair, two pooled blocks, a
residual pair, a global max pool, a dense head and a fixed 0.125 logit
scale. A block is a 3x3 convolution without bias, GroupNorm and CELU,
with a 2x2 max pool where the stage pools. The loss is the mean
cross-entropy.

Every product (each convolution and the head) goes through ``rnd``
(``precision.py``)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.sampler import CIFAR10_MEAN, CIFAR10_STD
from benchmark.yardstick.layout import resnet9_stages


def _block(cfg, rnd, p, pre: str, x, pool: bool):
    k = p[pre + "Conv_0/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = rnd.output(F.conv2d(rnd.operand(x), rnd.operand(k), padding=1))
    c = x.shape[1]
    g = cfg["norm_groups"] if c % cfg["norm_groups"] == 0 else c
    x = F.group_norm(x, g, p[pre + "GroupNorm_0/scale"],
                     p[pre + "GroupNorm_0/bias"], eps=cfg["norm_eps"])
    x = F.celu(x, alpha=cfg["celu_alpha"])
    return F.max_pool2d(x, 2) if pool else x


def loss(cfg: dict, p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         rnd) -> torch.Tensor:
    """One client's loss on ``batch`` (``x [B, H, W, 3]`` uint8, ``y
    [B]``)."""
    dev = batch["x"].device
    mean = torch.as_tensor(CIFAR10_MEAN, device=dev)
    std = torch.as_tensor(CIFAR10_STD, device=dev)
    x = ((batch["x"].to(torch.float32) / 255.0 - mean) / std)
    x = x.permute(0, 3, 1, 2)
    for name, _, _, pool in resnet9_stages(cfg):
        pre = f"params/{name}/"
        if name.startswith("Residual"):
            y = _block(cfg, rnd, p, pre + "ConvBlock_0/", x, False)
            x = x + _block(cfg, rnd, p, pre + "ConvBlock_1/", y, False)
        else:
            x = _block(cfg, rnd, p, pre, x, pool)
    x = x.amax(dim=(2, 3))
    logits = (rnd.output(torch.matmul(rnd.operand(x), rnd.operand(
        p["params/Dense_0/kernel"]))) + p["params/Dense_0/bias"]) * \
        cfg["logit_scale"]
    return F.cross_entropy(logits, batch["y"].long())

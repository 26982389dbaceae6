"""FixupResNet (the reference's ``models/fixup_resnet.py``), functional,
over views of the flat parameter vector.

ResNet-v1 bottlenecks with Fixup instead of normalization: each branch's
first two convs start He-normal scaled by ``L^(-1/4)`` (L blocks, m = 3
convs a branch), its last conv and the head start at zero, and learned
scalar biases and a scalar ``scale`` sit around the convs. The whole model
state is its parameters, which is what federated averaging and the flat
compression pipeline want.

stem conv7x7/2 (pad 3) -> bias -> relu -> max pool 3x3/2 (pad 1) ->
``stage_sizes`` bottlenecks of width ``width * 2**stage`` (stride 2 at the
first block of every stage but the first) -> spatial mean -> bias ->
dense. NHWC at the public boundary, NCHW inside.

The dtype flow is flax's, op by op: each conv and the dense cast their
input and kernel to ``dtype`` and return ``dtype``; every scalar bias,
being an f32 param, promotes its sum to float32 (JAX's bf16 + f32 -> f32),
so the bias adds, the scale product, the residual add, the max pool and
the mean run in float32 under ``compute_dtype="mixed"``. The flat order
and the keys are flax's (``FixupBottleneck_10`` sorts before
``FixupBottleneck_2``); a block with a projection shortcut numbers that
conv ``Conv_0`` and its branch convs ``Conv_1..3``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

FIXUP_RESNET50_STAGES = (3, 4, 6, 3)


def _blocks(stage_sizes: Sequence[int], width: int):
    """(name, in channels, bottleneck width, has projection) of every
    block, in forward order."""
    out, cin, i = [], width, 0
    for stage, n in enumerate(stage_sizes):
        for block in range(n):
            f = width * 2**stage
            stride = 2 if stage > 0 and block == 0 else 1
            out.append((f"FixupBottleneck_{i}", cin, f,
                        cin != 4 * f or stride != 1))
            cin, i = 4 * f, i + 1
    return out


def _block_shapes(cin: int, f: int, proj: bool) -> Dict:
    convs = [(1, 1, cin, f), (3, 3, f, f), (1, 1, f, 4 * f)]
    if proj:
        convs.insert(0, (1, 1, cin, 4 * f))
    p = {f"Conv_{j}": {"kernel": s} for j, s in enumerate(convs)}
    p.update({f"_ScalarBias_{j}": {"bias": (1,)} for j in range(6)})
    p["scale"] = (1,)
    return p


def fixup_resnet_shapes(stage_sizes: Sequence[int] = FIXUP_RESNET50_STAGES,
                        num_classes: int = 1000, width: int = 64) -> Dict:
    """Nested dict of leaf shapes, keyed like flax's ``model.init`` (RGB
    input)."""
    p: Dict = {"Conv_0": {"kernel": (7, 7, 3, width)},
               "_ScalarBias_0": {"bias": (1,)},
               "_ScalarBias_1": {"bias": (1,)}}
    blocks = _blocks(stage_sizes, width)
    for name, cin, f, proj in blocks:
        p[name] = _block_shapes(cin, f, proj)
    p["Dense_0"] = {"bias": (num_classes,),
                    "kernel": (4 * blocks[-1][2], num_classes)}
    return {"params": p}


def _zero_init(path: Tuple[str, ...], stage_sizes, width) -> bool:
    """Fixup's zero inits: the head, and each branch's last conv."""
    if path[-2] == "Dense_0" and path[-1] == "kernel":
        return True
    if path[-1] != "kernel" or not path[-3].startswith("FixupBottleneck"):
        return False
    proj = {name: pr for name, _, _, pr in _blocks(stage_sizes, width)}
    return path[-2] == ("Conv_3" if proj[path[-3]] else "Conv_2")


def _kernel_scale(path: Tuple[str, ...], stage_sizes, width) -> float:
    """He scale of a kernel: ``L^(-1/4)`` on a branch's first two convs,
    1 on the stem and on a projection shortcut."""
    if not path[-3].startswith("FixupBottleneck"):
        return 1.0
    proj = {name: pr for name, _, _, pr in _blocks(stage_sizes, width)}
    branch = (("Conv_1", "Conv_2") if proj[path[-3]]
              else ("Conv_0", "Conv_1"))
    if path[-2] in branch:
        return float(sum(stage_sizes)) ** (-1.0 / (2 * 3 - 2))
    return 1.0


def init_fixup_resnet(seed: int, stage_sizes: Sequence[int] =
                      FIXUP_RESNET50_STAGES, num_classes: int = 1000,
                      width: int = 64, device="cpu") -> Dict:
    """The port's own initializer (FixupResNet-50's stages by default), in
    flax's distributions: He kernels
    (truncated normal at 2 sigma, fan-in, variance ``2 * scale^2``), zeros
    where Fixup wants them, unit ``scale``, zero scalar biases — drawn from
    a ``torch.Generator`` seeded with ``seed`` (JAX's bits are not
    reproduced; tests load JAX-made params instead)."""
    g = torch.Generator().manual_seed(seed)

    def make(path: Tuple[str, ...], shape: tuple) -> torch.Tensor:
        leaf = path[-1]
        if leaf == "kernel" and not _zero_init(path, stage_sizes, width):
            scale = _kernel_scale(path, stage_sizes, width)
            std = (2.0 * scale * scale / math.prod(shape[:-1])) ** 0.5 \
                / 0.87962566103423978
            t = torch.empty(shape)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=g)
            return t.to(device)
        if leaf == "scale":
            return torch.ones(shape, device=device)
        return torch.zeros(shape, device=device)

    def walk(node, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else make(path + (k,), v) for k, v in sorted(node.items())}

    return walk(fixup_resnet_shapes(stage_sizes, num_classes, width))


def _conv(x, kernel, dtype, stride=1, padding=0):
    """flax ``nn.Conv(dtype=dtype)``: input and HWIO kernel cast to
    ``dtype``, output in ``dtype``."""
    k = kernel.to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    return F.conv2d(x.to(dtype), k, stride=stride, padding=padding)


def _bias(x, p):
    """``_ScalarBias``: ``x + b[0]`` with ``b`` f32, so float32 out."""
    return x.to(torch.float32) + p["bias"][0]


def _bottleneck(p, x, stride: int, proj: bool, dtype):
    h = _bias(x, p["_ScalarBias_0"])
    j = 0
    shortcut = x
    if proj:
        shortcut = _conv(h, p["Conv_0"]["kernel"], dtype, stride)
        j = 1
    y = torch.relu(_bias(_conv(h, p[f"Conv_{j}"]["kernel"], dtype),
                         p["_ScalarBias_1"]))
    y = _conv(_bias(y, p["_ScalarBias_2"]), p[f"Conv_{j + 1}"]["kernel"],
              dtype, stride, padding=1)
    y = torch.relu(_bias(y, p["_ScalarBias_3"]))
    y = _conv(_bias(y, p["_ScalarBias_4"]), p[f"Conv_{j + 2}"]["kernel"],
              dtype)
    y = _bias(y.to(torch.float32) * p["scale"][0], p["_ScalarBias_5"])
    return torch.relu(y + shortcut.to(torch.float32))


def fixup_resnet_apply(params: Dict, x: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Logits ``[B, classes]`` (float32) for NHWC images ``x``; the
    ``stage_sizes`` and width are read from the params' keys and shapes."""
    p = params["params"]
    x = x.to(dtype).permute(0, 3, 1, 2)
    x = torch.relu(_bias(_conv(x, p["Conv_0"]["kernel"], dtype, 2, 3),
                         p["_ScalarBias_0"]))
    x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
    i = 0
    while f"FixupBottleneck_{i}" in p:
        blk = p[f"FixupBottleneck_{i}"]
        proj = "Conv_3" in blk
        # the projection blocks open the stages; all but the first stride 2
        x = _bottleneck(blk, x, 2 if proj and i > 0 else 1, proj, dtype)
        i += 1
    x = _bias(x.mean(dim=(2, 3)), p["_ScalarBias_1"])
    dense = p["Dense_0"]
    x = x.to(dtype) @ dense["kernel"].to(dtype) + dense["bias"].to(dtype)
    return x.to(torch.float32)

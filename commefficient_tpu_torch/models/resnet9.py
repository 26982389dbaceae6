"""ResNet-9 (the reference's ``models/resnet9.py``), functional, over views
of the flat parameter vector.

prep conv(w) -> conv(2w)+pool -> residual(2w) -> conv(4w)+pool ->
conv(8w)+pool -> residual(8w) -> global max pool -> dense -> x0.125.
Each conv block is conv3x3 (no bias) -> GroupNorm -> CELU(0.3) [-> 2x2
max pool]. NHWC at the public boundary like the reference; NCHW inside.

What must match flax (ROADMAP C hazards): GroupNorm eps is 1e-6 (flax's
default, torch's is 1e-5) with 16 groups (or one per channel when the
width is not a multiple of 16); conv kernels are stored HWIO and Dense
kernels ``[in, out]`` in the flat vector and permuted at use.

``dtype`` is the compute type: bfloat16 for ``compute_dtype="mixed"``
(weights and activations cast inside the loss, master params f32), float32
for ``"float32"``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

GN_EPS = 1e-6


def _stages(width: int, in_channels: int = 3):
    """(name, in, out, pool) of every conv block, in forward order; a
    Residual holds two blocks of equal width. ``in_channels`` is the
    images' (3; FEMNIST's grayscale 1)."""
    w = width
    return [
        ("ConvBlock_0", in_channels, w, False),
        ("ConvBlock_1", w, 2 * w, True),
        ("Residual_0", 2 * w, 2 * w, False),
        ("ConvBlock_2", 2 * w, 4 * w, True),
        ("ConvBlock_3", 4 * w, 8 * w, True),
        ("Residual_1", 8 * w, 8 * w, False),
    ]


def _block_shapes(cin: int, cout: int) -> Dict[str, Dict[str, tuple]]:
    return {"Conv_0": {"kernel": (3, 3, cin, cout)},
            "GroupNorm_0": {"bias": (cout,), "scale": (cout,)}}


def resnet9_shapes(num_classes: int = 10, width: int = 64,
                   in_channels: int = 3) -> Dict:
    """Nested dict of leaf shapes, keyed like flax's ``model.init``."""
    p: Dict = {}
    for name, cin, cout, _ in _stages(width, in_channels):
        if name.startswith("Residual"):
            p[name] = {"ConvBlock_0": _block_shapes(cin, cout),
                       "ConvBlock_1": _block_shapes(cout, cout)}
        else:
            p[name] = _block_shapes(cin, cout)
    p["Dense_0"] = {"bias": (num_classes,), "kernel": (8 * width,
                                                         num_classes)}
    return {"params": p}


def init_resnet9(seed: int, num_classes: int = 10, width: int = 64,
                 device="cpu", in_channels: int = 3) -> Dict:
    """The port's own initializer, in flax's distributions: lecun-normal
    (truncated at 2 sigma, fan-in) kernels, zero biases, unit GroupNorm
    scales — drawn from a ``torch.Generator`` seeded with ``seed``. It does
    not reproduce JAX's bits (tests load JAX-made params instead)."""
    g = torch.Generator().manual_seed(seed)

    def make(path: Tuple[str, ...], shape: tuple) -> torch.Tensor:
        leaf = path[-1]
        if leaf == "kernel":
            fan_in = 1
            for s in shape[:-1]:
                fan_in *= s
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
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

    return walk(resnet9_shapes(num_classes, width, in_channels))


def _conv_block(p, x: torch.Tensor, pool: bool, dtype) -> torch.Tensor:
    k = p["Conv_0"]["kernel"].to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = F.conv2d(x, k, padding=1)
    c = x.shape[1]
    gn = p["GroupNorm_0"]
    x = F.group_norm(x, 16 if c % 16 == 0 else c, gn["scale"].to(dtype),
                     gn["bias"].to(dtype), eps=GN_EPS)
    x = F.celu(x, alpha=0.3)
    return F.max_pool2d(x, 2) if pool else x


def resnet9_apply(params: Dict, x: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Logits ``[B, classes]`` (float32) for NHWC images ``x``."""
    p = params["params"]
    x = x.to(dtype).permute(0, 3, 1, 2)
    width = p["ConvBlock_0"]["Conv_0"]["kernel"].shape[-1]
    for name, _, _, pool in _stages(width):
        if name.startswith("Residual"):
            y = _conv_block(p[name]["ConvBlock_0"], x, False, dtype)
            x = x + _conv_block(p[name]["ConvBlock_1"], y, False, dtype)
        else:
            x = _conv_block(p[name], x, pool, dtype)
    x = x.amax(dim=(2, 3))
    dense = p["Dense_0"]
    x = x @ dense["kernel"].to(dtype) + dense["bias"].to(dtype)
    return x.to(torch.float32) * 0.125


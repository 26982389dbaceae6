"""Initial weights from the seed, made on the device as ONE flat float32
vector in the layout's order (``layout.py``): one random draw over the
whole vector, then each leaf's scale set on its slice. Both the program
and the reference start from this vector; neither makes its own."""

from __future__ import annotations

import math

import torch

from benchmark.yardstick.layout import leaves, offsets


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def initial_params(cfg: dict, seed: int, device) -> torch.Tensor:
    """``[D]`` float32 on ``device``: GPT-2's normal(0, initializer_range)
    embeddings and kernels; ResNet-9's lecun-normal kernels truncated at
    two standard deviations; zero biases and unit norm scales (the
    published initialisers)."""
    layout = leaves(cfg)
    spans = offsets(layout)
    d = spans[-1][1] + spans[-1][2]
    g = generator(seed, device)
    if cfg["family"] == "gpt2":
        vec = torch.randn(d, generator=g, device=device)
        vec.mul_(cfg["initializer_range"])
    else:
        vec = torch.empty(d, device=device)
        torch.nn.init.trunc_normal_(vec, 0.0, 1.0, -2.0, 2.0, generator=g)
    for (path, shape), (_, o, n) in zip(layout, spans):
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "scale":
            vec[o:o + n] = 1.0
        elif leaf == "bias":
            vec[o:o + n] = 0.0
        elif cfg["family"] == "resnet9":  # kernel: lecun normal, fan in
            fan_in = math.prod(shape[:-1])
            vec[o:o + n] *= (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return vec

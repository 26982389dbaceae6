"""The flat parameter vector's layout, frozen here: each leaf's path and
shape in ravel order (nested keys sorted at every level, each leaf
row-major), which is the order the program's master ``[D]`` vector, its
gradient and its sketch coordinates use. Built from a configuration
file's sizes alone; the program's own shape tables are not read."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

Leaves = List[Tuple[str, Tuple[int, ...]]]


def _flatten(tree: Dict, prefix: str = "") -> Leaves:
    out: Leaves = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        v = tree[key]
        if isinstance(v, dict):
            out.extend(_flatten(v, path))
        else:
            out.append((path, tuple(v)))
    return out


def gpt2_leaves(cfg: dict) -> Leaves:
    """GPT-2 with the double heads: token table (the base vocabulary plus
    the task's special tokens, tied to the LM head), positions, pre-LN
    blocks, final LayerNorm and a one-output multiple-choice head."""
    E = cfg["n_embd"]
    V = cfg["vocab_size"] + cfg.get("added_special_tokens", 0)
    inner = cfg.get("n_inner") or 4 * E

    def dense(n_in, n_out):
        return {"bias": (n_out,), "kernel": (n_in, n_out)}

    def ln():
        return {"bias": (E,), "scale": (E,)}

    tr = {"wte": (V, E), "wpe": (cfg["n_positions"], E), "ln_f": ln()}
    for i in range(cfg["n_layer"]):
        tr[f"h_{i}"] = {"ln_1": ln(), "ln_2": ln(),
                        "attn": {"c_attn": dense(E, 3 * E),
                                 "c_proj": dense(E, E)},
                        "mlp": {"c_fc": dense(E, inner),
                                "c_proj": dense(inner, E)}}
    return _flatten({"params": {"transformer": tr, "mc_head": dense(E, 1)}})


RESNET9_STAGES = (("ConvBlock_0", 0, 1, False), ("ConvBlock_1", 1, 2, True),
                  ("Residual_0", 2, 2, False), ("ConvBlock_2", 2, 4, True),
                  ("ConvBlock_3", 4, 8, True), ("Residual_1", 8, 8, False))


def resnet9_stages(cfg: dict):
    """(name, in channels, out channels, pool) of each stage; in channels
    0 stands for the image's."""
    w = cfg["width"]
    return [(name, cfg["in_channels"] if a == 0 else a * w, b * w, pool)
            for name, a, b, pool in RESNET9_STAGES]


def resnet9_leaves(cfg: dict) -> Leaves:
    """ResNet-9 (Page's cifar10-fast, FetchSGD's): 3x3 convolutions
    stored HWIO, GroupNorm scale and bias, a dense head ``[in, out]``."""

    def block(cin, cout):
        return {"Conv_0": {"kernel": (3, 3, cin, cout)},
                "GroupNorm_0": {"bias": (cout,), "scale": (cout,)}}

    p: Dict = {}
    for name, cin, cout, _ in resnet9_stages(cfg):
        p[name] = ({"ConvBlock_0": block(cin, cout),
                    "ConvBlock_1": block(cout, cout)}
                   if name.startswith("Residual") else block(cin, cout))
    p["Dense_0"] = {"bias": (cfg["num_classes"],),
                    "kernel": (8 * cfg["width"], cfg["num_classes"])}
    return _flatten({"params": p})


LEAVES = {"gpt2": gpt2_leaves, "resnet9": resnet9_leaves}


def leaves(cfg: dict) -> Leaves:
    return LEAVES[cfg["family"]](cfg)


def offsets(layout: Leaves) -> List[Tuple[str, int, int]]:
    """(path, start, size) of each leaf in the flat vector."""
    out, o = [], 0
    for path, shape in layout:
        n = math.prod(shape)
        out.append((path, o, n))
        o += n
    return out


def num_params(layout: Leaves) -> int:
    return sum(math.prod(s) for _, s in layout)

"""The flat parameter vector — the unit of compression.

The master state is ONE float32 ``[D]`` vector in exactly the order of
``jax.flatten_util.ravel_pytree`` over the reference's flax params: nested
dict keys sorted at every level, each leaf row-major in flax's own layout
(HWIO conv kernels, ``[in, out]`` Dense kernels). Models read their leaves
as views of that vector (``unravel``) and permute at use, so a gradient
taken with respect to the vector lands in the reference's coordinate
order with no re-layout, and sketch tables compare coordinate for
coordinate across the two packages.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def tree_leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict in ravel order (keys sorted at
    every level, a list's items in order, as JAX flattens them)."""
    out = []
    items = (((str(i), v) for i, v in enumerate(tree))
             if isinstance(tree, list)
             else ((key, tree[key]) for key in sorted(tree)))
    for key, v in items:
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(v, (dict, list)):
            out.extend(tree_leaves(v, path))
        else:
            out.append((path, v))
    return out


def tree_with_leaves(tree: Tree, leaves) -> Tree:
    """``tree``'s nested dict (and list) structure holding ``leaves`` (in
    ``tree_leaves`` order) in place of its own."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, list):
            return [build(v) for v in node]
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def make_unravel(shapes: List[Tuple[str, tuple]]) -> Callable[[torch.Tensor],
                                                                Tree]:
    """``vec [D] -> nested dict of VIEWS`` for the (path, shape) layout in
    ravel order. Views share storage with ``vec``, so autograd through them
    accumulates straight into the flat gradient."""
    offsets, off = [], 0
    for _, shape in shapes:
        offsets.append(off)
        off += math.prod(shape)
    total = off

    def unravel(vec: torch.Tensor) -> Tree:
        if vec.shape != (total,):
            raise ValueError(f"expected a [{total}] vector, got "
                             f"{tuple(vec.shape)}")
        tree: Tree = {}
        for (path, shape), o in zip(shapes, offsets):
            node = tree
            *parents, leaf = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = vec[o:o + math.prod(shape)].view(shape)
        return tree

    return unravel


def ravel_params(tree: Tree) -> Tuple[torch.Tensor, Callable]:
    """Flatten a nested dict of tensors/arrays to a float32 ``[D]`` vector
    (on the leaves' device) plus its unraveler."""
    leaves = tree_leaves(tree)
    flat = [v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            for _, v in leaves]
    vec = torch.cat([t.reshape(-1).to(torch.float32) for t in flat])
    return vec, make_unravel([(p, tuple(t.shape))
                              for (p, _), t in zip(leaves, flat)])


def clip_by_global_norm(vec: torch.Tensor, max_norm) -> torch.Tensor:
    """Scale ``vec`` so its L2 norm is at most ``max_norm`` (None = no
    clip) — the reference's formula, ``min(1, max_norm / (norm + 1e-12))``."""
    if max_norm is None:
        return vec
    norm = torch.linalg.vector_norm(vec)
    return vec * torch.clamp(max_norm / (norm + 1e-12), max=1.0)

"""Weight carrier between the reference's flax params and the port.

JAX's PRNG cannot be reproduced in torch, so parity tests initialize the
reference model, export its params as numpy, and load them here. The flat
order is ``ravel_pytree``'s (ops/param_utils.py), so the round trip is
bit-identical. Nothing here imports JAX: the caller converts to numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from commefficient_tpu_torch.ops.param_utils import tree_leaves


def params_from_jax(tree: Dict[str, Any], device="cpu") -> torch.Tensor:
    """Nested dict of numpy arrays (flax params) -> float32 ``[D]``."""
    parts = [np.asarray(v, np.float32).reshape(-1)
             for _, v in tree_leaves(tree)]
    return torch.from_numpy(np.concatenate(parts)).to(device)


def params_to_jax(vec: torch.Tensor, like: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``params_from_jax``: ``[D]`` -> nested dict of numpy
    arrays shaped like ``like``."""
    flat = vec.detach().to("cpu", torch.float32).numpy()
    out: Dict[str, Any] = {}
    off = 0
    for path, leaf in tree_leaves(like):
        shape = np.shape(leaf)
        n = int(np.prod(shape))
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = flat[off:off + n].reshape(shape).copy()
        off += n
    if off != flat.size:
        raise ValueError(f"vector has {flat.size} entries, the tree {off}")
    return out

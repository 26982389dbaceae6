"""Weight and state carrier between the reference and the port.

JAX's PRNG cannot be reproduced in torch, so parity tests initialize the
reference model (and state drawn from its PRNG, such as powersgd's
warm-start ``Q``), export it as numpy, and load it here. The flat order is
``ravel_pytree``'s (ops/param_utils.py), so the round trip is
bit-identical. Nothing here imports JAX: the caller converts to numpy.

A state carries the reference's full layout: a leaf the reference shards
over its workers axis (true_topk's momentum and error under sparse
aggregation, FSDP's params and dense state) is the whole padded
``[padded_dim]`` vector, as ``np.asarray`` of the sharded array gives it.
A session whose ranks hold slices of those leaves converts with
``FederatedSession.full_state`` (before ``state_to_jax``) and
``set_full_state`` (after ``state_from_jax``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from commefficient_tpu_torch.ops.param_utils import tree_leaves
from commefficient_tpu_torch.parallel.round import FedState

# the reference's FedState leaves, in its field order
STATE_LEAVES = ("params_vec", "momentum", "error", "client_vel",
                "client_err", "step", "comp")


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


def _absent(leaf) -> bool:
    """The reference marks an absent leaf with ``()``; numpy turns that
    into an empty array."""
    return leaf is None or np.size(leaf) == 0


def state_from_jax(leaves: Dict[str, Any], device="cpu") -> FedState:
    """The reference's ``FedState`` leaves as numpy (``{name: array | ()}``
    over ``STATE_LEAVES``) -> the port's ``FedState`` on ``device``: f32
    tensors (bf16 where the reference stores bf16 tables), ``None`` where
    the reference holds ``()``, ``step`` an int."""
    out = {}
    for name in STATE_LEAVES:
        leaf = leaves[name]
        if name == "step":
            out[name] = int(np.asarray(leaf))
        elif _absent(leaf):
            out[name] = None
        else:
            t = torch.from_numpy(np.array(leaf, np.float32)).to(device)
            if np.asarray(leaf).dtype.name == "bfloat16":
                t = t.to(torch.bfloat16)  # exact: the values are bf16
            out[name] = t
    return FedState(**out)


def state_to_jax(state: FedState) -> Dict[str, Any]:
    """Inverse of ``state_from_jax``: ``{name: numpy array | ()}``, the
    step a numpy int32 as the reference keeps it."""
    out = {}
    for name in STATE_LEAVES:
        leaf = getattr(state, name)
        if name == "step":
            out[name] = np.int32(leaf)
        elif leaf is None:
            out[name] = ()
        else:
            out[name] = leaf.detach().to("cpu", torch.float32).numpy()
    return out

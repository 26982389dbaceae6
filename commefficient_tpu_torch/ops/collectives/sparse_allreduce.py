"""Sparse allreduce over the worker group: an O(W*k) pair exchange, not an
O(D) reduction (the reference's ``ops/collectives/sparse_allreduce.py``).

A worker compacts its at-most-k-sparse vector into a fixed-size pair
buffer (``compact_pairs``: int64 indices, ``(0, 0.0)`` padding), the
buffers are exchanged, and the sum is rebuilt by a scatter-add in which
the pads add nothing (Near-Optimal Sparse Allreduce, arXiv:2201.07598).
Every function takes the worker group (``parallel/mesh.py``) where the
reference names its mesh axis; on a group of one they reduce to local
work.

Two exchange schedules:

* ``sparse_allreduce``: one ``all_gather`` of every rank's pair buffer,
  then a local scatter-add; every rank ends with the whole dense sum (the
  reference's replicated ``P()`` output). Receive volume: W*k pairs.
* ``sparse_allreduce_sharded``: balanced index ranges and a
  recursive-halving butterfly. The index space ``[0, dp)`` halves each
  step; each rank sends the pairs of the half it does not keep to its
  hypercube partner (``exchange``) and scatter-adds what it receives.
  After log2(W) steps rank i holds its range ``[i*S, (i+1)*S)`` of the
  sum (``S = ceil(d / W)``). Capacities double each step (k, 2k, ...), so
  each rank moves (W-1)*k pairs in all. ``axis_sizes=(H, W_local)`` runs
  the reference's two-level order instead (the bits inside a host first,
  then those across hosts), with the same result on the same ranks.

Both equal the dense sum up to f32 summation order.

The scatter-add of gathered pairs (``scatter_add_pairs``) adds the W rank
buffers one after another, one ``index_add_`` a buffer: within a compacted
buffer the only repeated coordinate is the ``(0, 0.0)`` pad, and adding
0.0 is exact in any order, so on the card (where ``index_add_`` sums
repeated indices by float atomics) the sum is the same bit for bit as
the reference's in-order scatter over the concatenated buffers: rank
order.

Layerwise overlap (``overlap_collectives='layerwise'``): the segmented
forms split one collective into independent ones, each issued
asynchronously before the first is waited on. ``all_gather_pairs(
segments=S)`` is pure data movement (the ordered concatenation of the
segment gathers IS the monolithic gather, bit for bit), and
``psum_segments`` relies on a sum over ranks being elementwise: each
element is summed once whichever collective carries it, so per-segment
sums equal one sum of the concatenated segments.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from commefficient_tpu_torch.ops.topk import compact_nonzero

# segments of the layerwise overlap's chunked exchanges (the reference's)
OVERLAP_SEGMENTS = 4


def _segment_bounds(n: int, segments: int):
    """``[start, stop)`` bounds splitting ``[0, n)`` into up to
    ``segments`` contiguous near-equal chunks, every chunk non-empty."""
    s = max(1, min(int(segments), int(n)))
    step = -(-n // s)
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def compact_pairs(v: torch.Tensor,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx, val)`` buffer of the first ``capacity`` nonzeros of [n]
    ``v``: the exchange's one spelling of the contract documented on
    ``ops.topk.compact_nonzero``."""
    return compact_nonzero(v, capacity)


def all_gather_pairs(idx: torch.Tensor, val: torch.Tensor, group,
                     segments: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's [kb] pair buffer concatenated in rank order:
    ``[size * kb]`` buffers on every rank. ``segments=S`` (layerwise
    overlap) gathers up to S contiguous chunks of the buffer, each by its
    own asynchronous ``all_gather``, and lays them back out as the
    monolithic ``[size, kb]`` layout: bit-equal to ``segments=None``."""
    if segments is None or int(segments) <= 1 or idx.shape[0] <= 1:
        return group.all_gather(idx), group.all_gather(val)
    bounds = _segment_bounds(idx.shape[0], segments)
    out = []
    for t in (idx, val):
        pending = [group.all_gather_async(t[a:b]) for a, b in bounds]
        out.append(torch.cat([p.wait().reshape(group.size, -1)
                              for p in pending], dim=1).reshape(-1))
    return out[0], out[1]


def psum_segments(segments: Sequence[torch.Tensor], group):
    """Each segment summed over the group by its own collective, all
    issued before the first is waited on (in place; returns the sums).
    Bit-equal, element for element, to ``psum_segments_fused``."""
    pending = [group.all_reduce_sum_async(s) for s in segments]
    return tuple(p.wait() for p in pending)


def psum_segments_fused(segments: Sequence[torch.Tensor], group):
    """The monolithic twin of ``psum_segments``: one sum of the flattened
    and concatenated segments, split back to their shapes (the equality
    reference of the overlap; the segments share a dtype)."""
    flat = group.all_reduce_sum(torch.cat([s.reshape(-1) for s in segments]))
    out, off = [], 0
    for s in segments:
        out.append(flat[off:off + s.numel()].reshape(s.shape))
        off += s.numel()
    return tuple(out)


def scatter_add_pairs(dim: int, idx: torch.Tensor, val: torch.Tensor,
                      buffers: int = 1) -> torch.Tensor:
    """Dense ``[dim]`` sum of the pairs. The pairs are ``buffers`` equal
    blocks (the gathered rank buffers, in rank order), added one block
    after another, one ``index_add_`` a block; repeated coordinates
    across blocks accumulate in block order. A block must repeat no
    coordinate but the ``(i, 0.0)`` pads for the card to give the same
    bits (module docstring); on the CPU any repeats add in order."""
    out = torch.zeros(int(dim), dtype=val.dtype, device=val.device)
    for i, v in zip(idx.reshape(buffers, -1), val.reshape(buffers, -1)):
        out.index_add_(0, i, v)
    return out


def sparse_allreduce(v: torch.Tensor, capacity: int, group,
                     segments: Optional[int] = None) -> torch.Tensor:
    """The sum over the group of an at-most-``capacity``-sparse dense
    [d] vector by its pairs: compact, ``all_gather_pairs``, then the
    rank-by-rank scatter-add. Every rank gets the dense [d] sum, equal to
    ``all_reduce_sum(v)`` up to f32 summation order when each rank's
    ``v`` has at most ``capacity`` nonzeros (beyond it the first by
    position are kept). ``segments`` chunks the gather (bit-equal)."""
    idx, val = compact_pairs(v, capacity)
    g_idx, g_val = all_gather_pairs(idx, val, group, segments=segments)
    return scatter_add_pairs(v.shape[0], g_idx, g_val, buffers=group.size)


def sparse_allreduce_sharded(v: torch.Tensor, k: int, group, *,
                             axis_sizes=None) -> torch.Tensor:
    """This rank's balanced range ``[rank*S, (rank+1)*S)`` of the sum over
    the group of an at-most-k-sparse dense [d] vector, ``S = ceil(d /
    size)`` (the tail past d is zeros), by the recursive-halving
    butterfly (module docstring). Equal to slicing the dense sum up to
    f32 summation order. The group's size must be a power of two.

    At the step for rank bit b a rank sends the still-kept coordinates
    whose owner block differs from its own rank at b (compacted, at most
    the step's capacity) to its partner ``rank ^ b`` and scatter-adds what
    the partner sends. The bits go from the highest down, so the kept set
    halves as one range (the reference's single-level schedule), or, with
    ``axis_sizes=(H, W_local)`` (``H * W_local == size``, both powers of
    two), the bits inside a host (rank % W_local) first and then those
    across hosts (the reference's two-level schedule); each rank ends with
    its own block either way."""
    n_dev = group.size
    sizes = (n_dev,) if axis_sizes is None else tuple(
        int(s) for s in axis_sizes)
    for n in sizes:
        if n <= 0 or (n & (n - 1)) != 0:
            raise ValueError(
                "sparse_allreduce_sharded needs power-of-two group sizes "
                f"for the recursive-halving schedule, got {sizes}")
    if axis_sizes is None:
        bits = [n_dev >> i for i in range(1, n_dev.bit_length())]
    else:
        n_hi, n_lo = sizes
        if n_hi * n_lo != n_dev:
            raise ValueError(f"axis_sizes {sizes} do not multiply to the "
                             f"group's {n_dev} ranks")
        bits = ([1 << i for i in range(n_lo.bit_length() - 1)]
                + [n_lo << i for i in range(n_hi.bit_length() - 1)])
    d = v.shape[0]
    shard = -(-d // n_dev)
    dp = shard * n_dev
    cap = min(int(k), dp)
    acc = torch.nn.functional.pad(v, (0, dp - d))
    me = group.rank
    blocks = torch.arange(dp, device=v.device) // shard
    kept = torch.ones(dp, dtype=torch.bool, device=v.device)
    for bit in bits:
        diff = ((blocks ^ me) & bit) != 0
        send = kept & diff
        idx, val = compact_nonzero(torch.where(send, acc, 0.0), cap)
        r_idx = group.exchange(idx, me ^ bit)
        r_val = group.exchange(val, me ^ bit)
        # the sent coordinates now belong to the partner; fold in what
        # arrived (one buffer: no coordinate repeats but the pads)
        acc = torch.where(send, 0.0, acc).index_add_(0, r_idx, r_val)
        kept = kept & ~diff
        cap = min(cap * 2, dp)  # the accumulated sparsity doubles a step
    return acc[me * shard:(me + 1) * shard]

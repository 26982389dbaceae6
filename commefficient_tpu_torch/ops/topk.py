"""Top-k sparsification (the reference's ``ops/topk.py``).

Two selections, as in the reference:

* exact: ``torch.topk`` on |v| with ``jax.lax.top_k``'s tie rule: among
  equal magnitudes the lower index is taken, and the result is ordered by
  descending magnitude, lower index first. ``torch.topk`` alone breaks ties
  in no stated order, which would let the two packages select different
  coordinates when magnitudes tie at the k-th place (ROADMAP C hazard 3).
  ``topk_sparsify`` returns the (values, indices) pairs (the server's
  sparse outputs); ``topk_dense`` the same set as a mask, whose shapes do
  not depend on the data. ``topk_method='approx'`` (the reference's
  ``lax.approx_max_k``) runs these too: ``approx_max_k`` is approximate
  only on a TPU, while XLA on the CPU and on a GPU lowers it to the exact
  selection, so the exact selection IS it here, ties included.
* threshold: a bisection on a magnitude threshold that selects AT MOST k
  entries, with no sort and no scatter; its sharded form needs only two
  scalar collectives per step, so a vector split over the worker group is
  top-k'ed without ever being gathered. Every step stays on the device:
  the loop runs a fixed number of steps and never reads a value back.

The reference leaves both to XLA; neither is a Pallas kernel.
"""

from __future__ import annotations

import torch

THRESHOLD_ITERS = 32  # the reference's bisection steps


def graph_capturing(t: torch.Tensor) -> bool:
    """True while a CUDA graph is being captured on ``t``'s stream (the
    scan engine's rounds): the selections then take their forms whose
    shapes do not depend on the data."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def topk_sparsify(v: torch.Tensor, k: int):
    """(values [k], indices [k]) of the k largest-|.| entries of flat v.
    While a CUDA graph is being captured it is ``topk_static``: the
    ``nonzero`` here reads a count back to the host, which a graph cannot
    hold."""
    if graph_capturing(v):
        return topk_static(v, k)
    mag = torch.abs(v)
    t = torch.topk(mag, k, sorted=False).values.min()
    above = torch.nonzero(mag > t).squeeze(1)
    ties = torch.nonzero(mag == t).squeeze(1)[: k - above.numel()]
    idx = torch.cat([above, ties])
    # descending magnitude, lower index first among equals (idx ascends
    # within each group, and the sort is stable)
    idx = idx[torch.sort(mag[idx], descending=True, stable=True).indices]
    return v[idx], idx


SCAN_BLOCK = 4096  # topk_dense's tie ranks: a scan within blocks of this


def _inclusive_count(mask: torch.Tensor) -> torch.Tensor:
    """The running count of ``mask`` along the last dimension (int32), as
    a scan within blocks of SCAN_BLOCK plus the blocks' offsets: on the
    card a scan along a few long rows (a ``[w, D]`` batch) runs one block
    a row, several times slower than w scans of one row; short rows in
    their thousands do not."""
    n = mask.shape[-1]
    blocks = torch.nn.functional.pad(mask.to(torch.int32),
                                     (0, -n % SCAN_BLOCK))
    within = torch.cumsum(blocks.unflatten(-1, (-1, SCAN_BLOCK)), dim=-1)
    totals = within[..., -1]
    offsets = torch.cumsum(totals, dim=-1) - totals
    return (within + offsets.unsqueeze(-1)).flatten(-2)[..., :n]


def topk_dense(v: torch.Tensor, k: int) -> torch.Tensor:
    """Dense vector keeping only the top-k entries of v by magnitude (over
    the last dimension): the set ``topk_sparsify`` selects, as a mask.
    ``t`` is the k-th largest |v| (NaN if a NaN is among the k, as
    ``topk_sparsify``'s min; then nothing is kept); every entry above
    ``t`` is kept, and of the entries equal to ``t`` the first ``k -
    count(|v| > t)`` by index (a running count of the ties). No shape
    depends on the data, so it runs under ``torch.func.vmap`` (local_topk's
    batched clients)."""
    keep = _topk_keep(torch.abs(v), k)
    return torch.where(keep, v, torch.zeros((), dtype=v.dtype,
                                            device=v.device))


def _topk_keep(mag: torch.Tensor, k: int) -> torch.Tensor:
    """``topk_dense``'s mask over the last dimension of ``mag = |v|``."""
    t = torch.topk(mag, k, dim=-1, sorted=False).values.amin(-1, keepdim=True)
    above = mag > t
    ties = mag == t
    room = k - torch.sum(above, dim=-1, keepdim=True)
    return above | (ties & (_inclusive_count(ties) <= room))


def topk_static(v: torch.Tensor, k: int):
    """``topk_sparsify`` of flat ``v`` with shapes that do not depend on
    the data (what a captured CUDA graph can hold): ``topk_dense``'s set,
    compacted in position order by a cumsum and ``searchsorted`` (as
    ``compact_nonzero``), then ordered by descending magnitude, lower
    index first (a stable sort of positions that ascend), which is
    ``topk_sparsify``'s order: its entries above the k-th magnitude come
    before its ties, and each group ascends. With a NaN among the k
    ``topk_sparsify`` keeps nothing and this gives k pads ``(0, 0.0)``;
    scattered into a zero vector both are the zero vector."""
    n = v.shape[0]
    mag = torch.abs(v)
    keep = _topk_keep(mag, k)
    csum = torch.cumsum(keep.to(torch.int64), 0)
    slots = torch.arange(1, k + 1, dtype=torch.int64, device=v.device)
    idx = torch.clamp(torch.searchsorted(csum, slots, side="left"),
                      max=n - 1)
    valid = slots <= csum[-1]
    idx = torch.where(valid, idx, 0)
    order = torch.sort(torch.where(valid, mag[idx], -1.0), descending=True,
                       stable=True).indices
    idx = idx[order]
    vals = torch.where(valid[order], v[idx],
                       torch.zeros((), dtype=v.dtype, device=v.device))
    return vals, idx


def _threshold_select(v: torch.Tensor, k: int, count, hi0: torch.Tensor,
                      iters: int) -> torch.Tensor:
    """The reference's bisection: ``count(t)`` is the number of entries
    with ``|v| >= t`` (over the whole group for the sharded form). After
    ``iters`` steps ``hi`` is the smallest tested threshold whose count is
    <= k. ``mid = 0.5 * (lo + hi)`` in f32, ``lo`` starts at ``hi0 * 0.0``
    (NaN-propagating like the reference's), and when more than k entries
    tie at the max no threshold selects <= k: the tied set is dropped
    (``hi = inf``), which keeps the at-most-k contract."""
    mag = torch.abs(v)
    lo, hi = hi0 * 0.0, hi0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = count(mid) > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    hi = torch.where(count(hi) > k, torch.full_like(hi, float("inf")), hi)
    # (mag > 0) guards the all-zero vector, where hi stays 0
    return v * ((mag >= hi) & (mag > 0))


def topk_threshold_dense(v: torch.Tensor, k: int,
                         iters: int = THRESHOLD_ITERS) -> torch.Tensor:
    """Dense top-<=k of flat v by magnitude: ``v`` where ``|v| >= t`` for
    the smallest tested ``t`` that selects at most k entries, else 0.
    Exact ties at the threshold are dropped rather than broken."""
    mag = torch.abs(v)
    return _threshold_select(v, k, lambda t: torch.sum(mag >= t),
                             torch.max(mag), iters)


def topk_threshold_sharded(v_local: torch.Tensor, k: int, group,
                           iters: int = THRESHOLD_ITERS) -> torch.Tensor:
    """``topk_threshold_dense`` of a vector split over ``group``
    (``parallel.mesh``): each rank holds its slice and gets back its slice
    of the global selection. One scalar ``all_reduce_max`` for the start
    and one scalar ``all_reduce_sum`` of the count per step."""
    mag = torch.abs(v_local)
    return _threshold_select(
        v_local, k, lambda t: group.all_reduce_sum(torch.sum(mag >= t)),
        group.all_reduce_max(torch.max(mag)), iters)


def compact_nonzero(v: torch.Tensor, k: int):
    """Compact an at-most-k-sparse [n] vector into fixed-size ``(idx [kb]
    int64, val [kb])`` buffers, ``kb = min(k, n)``: positions ascending,
    padded with ``(0, 0.0)``. A cumsum over the nonzero mask gives each
    nonzero its slot and ``searchsorted`` inverts it (no sort, no scatter).
    Consumers rely on the padding: a scatter-add of a pad adds 0.0, and
    masks taken from ``val != 0`` drop the pads. With more than k nonzeros
    the first kb by position are kept."""
    n = v.shape[0]
    kb = min(int(k), n)
    csum = torch.cumsum((v != 0).to(torch.int64), 0)
    slots = torch.arange(1, kb + 1, dtype=torch.int64, device=v.device)
    idx = torch.clamp(torch.searchsorted(csum, slots, side="left"), max=n - 1)
    valid = slots <= csum[-1]
    return (torch.where(valid, idx, 0),
            torch.where(valid, v[idx], torch.zeros((), dtype=v.dtype,
                                                   device=v.device)))


def mask_out_indices(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v`` with the coordinates ``idx`` set to 0 (a new tensor): the
    error feedback's "forget what was sent" step."""
    return v.index_fill(0, idx.to(torch.int64), 0.0)

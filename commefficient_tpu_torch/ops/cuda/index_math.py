"""The CountSketch kernels' index arithmetic, planned on the host.

What the CUDA kernels of ``csrc/countsketch.cu`` need planned on the host,
in numpy and Python integers (the kernels themselves run only on the
card; ``tests/test_torch_kernel_index_math.py`` holds these plans, and
mirrors of the kernels' own index loops, on the CPU):

* ``fast_divisor``: the multiplier and shift that replace a runtime
  ``n / d`` in the kernels, exact for every dividend up to a stated bound;
  ``udiv`` emulates the device formula with Python ints.
* K1's tile width (``sketch_tile_strides``, from the shared memory a
  tile block needs);
* K4's range form: ``range_block_list`` orders a coordinate slice's
  scramble blocks by scrambled position, and ``range_windows`` finds, per
  row and per CUDA block, the table window that the block reads.
"""

from __future__ import annotations

import numpy as np

U32 = 1 << 32
SHIFT_WIDE = 64  # shift value that selects the 64-bit multiply-high form


def fast_divisor(d: int, n_max: int) -> tuple:
    """``(mul, shift)`` with ``udiv(n, mul, shift) == n // d`` for every
    ``0 <= n <= n_max < 2^32``.

    The narrow form is ``(n * mul) >> shift`` with ``mul < 2^32`` (one
    32x32->64 multiply and a shift on the card); it is exact whenever
    ``n_max * e < 2^shift``, where ``e = mul * d - 2^shift`` is the
    rounding excess of ``mul = ceil(2^shift / d)``. A power of two gets
    ``mul = 1``. Where no narrow shift is exact up to ``n_max`` (a divisor
    near 2^k with dividends near 2^32), the wide form ``umul64hi(n, mul)``
    with ``mul = ceil(2^64 / d)`` is exact for every 32-bit ``n``
    (``shift == SHIFT_WIDE`` selects it)."""
    if not 1 <= d < U32:
        raise ValueError(f"divisor {d} outside [1, 2^32)")
    if not 0 <= n_max < U32:
        raise ValueError(f"dividend bound {n_max} outside [0, 2^32)")
    for shift in range(64):
        mul = -(-(1 << shift) // d)
        if mul >= U32:
            break
        if n_max * (mul * d - (1 << shift)) < (1 << shift):
            return mul, shift
    return -(-(1 << 64) // d), SHIFT_WIDE


def udiv(n, mul: int, shift: int):
    """The kernels' ``cs_udiv`` on Python ints (or an int64/object numpy
    array): ``(n * mul) >> shift``, or the high 64 bits of ``n * mul``."""
    if shift == SHIFT_WIDE:
        return (n * mul) >> 64
    return (n * mul) >> shift


# -- K1: the tile walk ---------------------------------------------------------

K1_THREADS = 512  # threads of a K1 tile block (kThreadsK1 in countsketch.cu)
K1_MAX_STRIDES = 32  # widest tile, in strides of the row
K1_MAX_PER_THREAD = 16  # chunk values a thread stages (m <= 16 * 512)
K1_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on the H100


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def sketch_smem_bytes(m: int, V: int, tile_cols: int) -> int:
    """Dynamic shared memory of one K1 tile block: the row's CSR pointers
    (V+1 uint16, padded), the chunk stage (m f32) and the tile's sums
    (f32). Same layout as ``cs_tile_smem`` in ``csrc/countsketch.cu``."""
    return _align16(2 * (V + 4)) + _align16(4 * m) + _align16(4 * tile_cols)


def sketch_tile_strides(rows) -> int:
    """Tile width W in strides for K1 at a spec whose rows are ``rows``
    (``(m, s, V)`` per row): the widest power of two up to
    ``K1_MAX_STRIDES`` whose block fits the shared-memory limit at every
    row; 0, which selects the gather kernel, when even one stride does not
    fit or a chunk holds more than ``K1_MAX_PER_THREAD`` values per
    thread."""
    if any(m > K1_MAX_PER_THREAD * K1_THREADS for m, _, _ in rows):
        return 0
    w = K1_MAX_STRIDES
    while w >= 1:
        if all(sketch_smem_bytes(m, V, w * s) <= K1_SMEM_LIMIT
               for m, s, V in rows):
            return w
        w //= 2
    return 0


# -- K4: the range form --------------------------------------------------------

K4R_COORDS = 4096  # coordinates per range-form block (rounded to blocks)
K4R_SMEM_BUDGET = 48 * 1024  # shared memory for staged table windows


def range_span(start: int, n: int, d: int) -> tuple:
    """Distinct original coordinates ``[xa, xb]`` of the clipped slice
    ``min(start + arange(n), d - 1)`` (n >= 1)."""
    return min(start, d - 1), min(start + n - 1, d - 1)


def range_block_list(inv_perm, b: int, start: int, n: int, d: int):
    """The slice's scramble blocks (original block ids, int32) sorted by
    scrambled position. ``inv_perm`` is None when the spec does not
    scramble; the kernel then walks blocks of ``b`` positions in place."""
    xa, xb = range_span(start, n, d)
    blocks = np.arange(xa // b, xb // b + 1, dtype=np.int64)
    if inv_perm is not None:
        blocks = blocks[np.argsort(inv_perm[blocks], kind="stable")]
    return blocks.astype(np.int32)


def range_windows(blocks, inv_perm, b: int, start: int, n: int, d: int,
                  geo, per_block: int):
    """Per CUDA block (``per_block`` list entries each) and per row, the
    first table column the block's coordinates reach and the window length
    that covers them: ``(wstart [nblk, r] int64, wlen [r] int64)``.
    ``geo`` is ``[(f, G, m, s, V), ...]`` per row. Exact, from each
    block's first and last scrambled position, including the piece past a
    riffle boundary (a multiple of G) where p = (i mod G) * f + i div G
    restarts low."""
    xa, xb = range_span(start, n, d)
    B = blocks.astype(np.int64)
    lo = np.maximum(xa - B * b, 0)
    hi = np.minimum(xb - B * b, b - 1)
    bs = B if inv_perm is None else inv_perm[B].astype(np.int64)
    i0, i1 = bs * b + lo, bs * b + hi
    nblk = -(-len(B) // per_block)
    pad = nblk * per_block - len(B)
    wstart = np.zeros((nblk, len(geo)), np.int64)
    wlen = np.zeros(len(geo), np.int64)
    for row, (f, G, m, s, V) in enumerate(geo):
        g0, g1 = i0 // G, i1 // G
        cross = g1 > g0
        pmin = np.where(cross, np.minimum((i0 % G) * f + g0, g0 + 1),
                        (i0 % G) * f + g0)
        pmax = np.where(cross, np.maximum((G - 1) * f + g1 - 1,
                                          (i1 % G) * f + g1),
                        (i1 % G) * f + g1)
        qmin = np.pad(pmin // m, (0, pad), constant_values=np.iinfo(
            np.int64).max).reshape(nblk, per_block).min(1)
        qmax = np.pad(pmax // m, (0, pad), constant_values=-1).reshape(
            nblk, per_block).max(1)
        wstart[:, row] = qmin * s
        wlen[row] = int(((qmax - qmin) * s + V).max()) if nblk else 0
    return wstart, wlen


def range_staged_rows(wlen, budget: int) -> list:
    """Rows whose windows go to shared memory: narrowest first while their
    f32 windows fit ``budget`` bytes in all. The others read the table in
    place."""
    staged, used = [], 0
    for row in sorted(range(len(wlen)), key=lambda r: wlen[r]):
        if used + 4 * int(wlen[row]) <= budget:
            staged.append(row)
            used += 4 * int(wlen[row])
    return sorted(staged)

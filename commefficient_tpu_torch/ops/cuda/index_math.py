"""The CountSketch kernels' index arithmetic, planned on the host.

What the CUDA kernels of ``csrc/`` (``countsketch.cu``, ``walk.cu``,
``riffle.cu``, ``segment.cu``) need planned on the host,
in numpy and Python integers (the kernels themselves run only on the
card; ``tests/test_torch_kernel_index_math.py`` holds these plans, and
mirrors of the kernels' own index loops, on the CPU):

* ``fast_divisor``: the multiplier and shift that replace a runtime
  ``n / d`` in the kernels, exact for every dividend up to a stated bound;
  ``udiv`` emulates the device formula with Python ints.
* K1's tile width (``sketch_tile_strides``, from the shared memory a
  tile block needs), and which of K1's designs a geometry takes
  (``sketch_design``: the tile kernel where the vector fits the L2, else
  the chunk design of ``csrc/riffle.cu``, with its own tile width);
* K4's range form: ``range_block_list`` orders a coordinate slice's
  scramble blocks by scrambled position, and ``range_windows`` finds, per
  row and per CUDA block, the table window that the block reads;
* K2, the walk over every coordinate: the range form's plan at
  ``(start, n) = (0, d)``, tiles of ``K2_COORDS`` positions, and whether
  the slot tables go to shared memory (``k2_slots_in_smem``); and which
  of K2's designs a geometry takes (``k2_design``: the walk where the
  table fits the L2 and its slot tables shared memory, else the row
  design of ``csrc/riffle.cu``, with each row's tile width
  ``k2_rows_lg``);
* K1's segment form (``csrc/segment.cu``): which leaves take the one-block
  path, the tile width, and the fixed scratch (pieces a window and its
  bytes).
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


# -- K1's chunk design (csrc/riffle.cu) ---------------------------------------

L2_BYTES = 50 * 2**20  # the H100's L2 cache
K1C_SMEM_LIMIT = 113 * 1024  # two chunk blocks a multiprocessor (228 KB)


K1C_THREADS = 512  # threads of a K1 chunk block (kThreadsK1c in riffle.cu)
K1C_GROUPS = 6  # float4 sums a thread holds at most (kChunkGroups)


def chunk_smem_bytes(m: int, V: int) -> int:
    """Dynamic shared memory of one K1 chunk block: the CSR pointers (V+1
    uint16, padded), the CSR offsets (m uint16) and two chunk buffers (m
    f32 each); the tile's sums are in registers. Same layout as
    ``cs_chunk_smem`` in ``csrc/riffle.cu``."""
    return _align16(2 * (V + 4)) + _align16(2 * m) + 2 * _align16(4 * m)


def chunk_tile_strides(rows) -> int:
    """Tile width W in strides for K1's chunk design at rows ``(m, s, V)``:
    the widest power of two up to ``K1_MAX_STRIDES`` whose W * s columns a
    block's threads hold in registers (``K1C_GROUPS`` groups of 4 a
    thread) at every row; 0 where the block's shared memory does not fit
    ``K1C_SMEM_LIMIT``, or a chunk is no whole number of 16-byte copies
    (m mod 4), or its CSR positions leave uint16 (m >= 2^16)."""
    if any(m % 4 or m >= 1 << 16 or chunk_smem_bytes(m, V) > K1C_SMEM_LIMIT
           for m, _, V in rows):
        return 0
    w = K1_MAX_STRIDES
    while w > 1 and any(w * s > 4 * K1C_GROUPS * K1C_THREADS
                        for _, s, _ in rows):
        w //= 2
    return w if all(w * s <= 4 * K1C_GROUPS * K1C_THREADS
                    for _, s, _ in rows) else 0


def sketch_design(rows, d_eff: int) -> tuple:
    """``(design, W)``: which K1 kernel a geometry takes, and its tile
    width in strides. Where the ``[d_eff]`` f32 vector fits the L2, the
    tile kernel (``"tiles"``, every row's strided reads hit L2) or, where
    its tile does not fit, the gather kernel (``"gather"``, W = 0);
    where it does not, the chunk design (``"chunks"``), whose rows past
    the first read a riffled copy in order, if its block fits."""
    if 4 * d_eff > L2_BYTES:
        w = chunk_tile_strides(rows)
        if w:
            return "chunks", w
    w = sketch_tile_strides(rows)
    return ("tiles", w) if w else ("gather", 0)


def riffle_pitch(row_lengths) -> int:
    """Floats a row of K1's riffled scratch: the longest padded length L of
    the rows past the first, rounded up to 4 (16-byte rows)."""
    return -(-max(row_lengths[1:], default=0) // 4) * 4


# -- K1's segment form: windows, row groups, pieces and tiles ---------------

SEG_PIECE = 8192  # values a scatter block takes; the small path's limit
SEG_BATCH = 2048  # pairs an owner block takes at a time (kSegBatch)
SEG_OWNER_THREADS = 256  # an owner block's threads, each owning T / 256 columns
SEG_MAX_TILES = 1024  # tiles a row (the scatter block's counters)
SEG_MAX_PIECES = 2048  # piece-rows of the scratch (an owner's run table)
SEG_TILE_SHIFTS = range(13, 7, -1)  # tiles of 8192 down to 256 columns
SEG_MIN_BUCKETS = 4 * 132  # owner blocks wanted: four a multiprocessor
SEG_SCRATCH_BUDGET = 64 * 2**20  # bytes of the scratch, at most


def segment_small(n: int) -> bool:
    """Whether a leaf of ``n`` values takes the one-launch path: its pairs
    fit one block's radix sort (512 threads x 16 keys; the sort's ~40 KB
    and the 64 KB of sorted pairs in shared memory)."""
    return n <= SEG_PIECE


def segment_tile_shift(g: int, c_actual: int) -> int:
    """log2 of the tile width T when ``g`` rows go through the passes
    together: the widest tile (up to 8192 columns, whose f32 sums take 32
    KB of an owner block's shared memory, three blocks to a
    multiprocessor) that still gives ``SEG_MIN_BUCKETS`` (row, tile)
    buckets, else the narrowest; a row may not have more than
    ``SEG_MAX_TILES`` tiles."""
    def tiles(t):
        return -(-c_actual >> t)

    shift = next((t for t in SEG_TILE_SHIFTS
                  if g * tiles(t) >= SEG_MIN_BUCKETS), SEG_TILE_SHIFTS[-1])
    shift = max(shift, min(SEG_TILE_SHIFTS[0],
                           (-(-c_actual // SEG_MAX_TILES) - 1).bit_length()))
    if tiles(shift) > SEG_MAX_TILES:
        raise ValueError(f"K1's segment form takes at most "
                         f"{SEG_MAX_TILES << SEG_TILE_SHIFTS[0]} columns, "
                         f"got {c_actual}")
    return shift


def segment_shifts(r: int, c_actual: int) -> list:
    """The tile shift for each row-group size 1..r."""
    return [segment_tile_shift(g, c_actual) for g in range(1, r + 1)]


def segment_scratch_bytes(capacity: int, ntiles: int) -> int:
    """Bytes of the segment form's scratch of ``capacity`` piece-rows (one
    row's pairs of one piece): ``SEG_PIECE`` uint16 columns in the tile
    each and as many f32 signed values (each array piece-row-major), then
    ``ntiles + 1`` int32 tile starts each, tile-major (``ntiles``: the
    most any row group's tiles take). Same layout as
    ``cs_sketch_segment`` in ``csrc/segment.cu``."""
    return capacity * (6 * SEG_PIECE + 4 * (ntiles + 1))


def segment_capacity(r: int, d: int, ntiles: int) -> int:
    """Piece-rows the scratch holds: as many as ``SEG_SCRATCH_BUDGET``
    allows, and no more than a leaf of ``d`` values (the whole vector) in
    every row needs."""
    return max(1, min(SEG_MAX_PIECES, r * -(-d // SEG_PIECE),
                      SEG_SCRATCH_BUDGET // segment_scratch_bytes(1, ntiles)))


def segment_windows(r: int, n: int, capacity: int) -> list:
    """The windows of a leaf of ``n`` values that does not take the small
    path, in launch order, as ``(row0, rows, k0, values)``: the rows go in
    as few groups as hold the whole leaf, of sizes as even as can be;
    where not even one row's pairs fit, each row alone in windows of
    ``capacity`` pieces."""
    pieces = -(-n // SEG_PIECE)
    most = min(r, capacity // pieces)
    if most:
        g = -(-r // -(-r // most))
        return [(row0, min(g, r - row0), 0, n) for row0 in range(0, r, g)]
    w = capacity * SEG_PIECE
    return [(row, 1, k0, min(w, n - k0)) for row in range(r)
            for k0 in range(0, n, w)]


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


def range_staged_rows(wlen, budget: int, itemsize: int = 4) -> list:
    """Rows whose windows go to shared memory: narrowest first while their
    windows, ``itemsize`` bytes an entry (the table's type), fit
    ``budget`` bytes in all. The others read the table in place."""
    staged, used = [], 0
    for row in sorted(range(len(wlen)), key=lambda r: wlen[r]):
        if used + itemsize * int(wlen[row]) <= budget:
            staged.append(row)
            used += itemsize * int(wlen[row])
    return sorted(staged)


# -- K2: the walk over every coordinate -----------------------------------------

K2_COORDS = 4096  # scrambled positions per K2 tile (rounded to scramble blocks)
K2_WINDOW_BUDGET = 48 * 1024  # shared memory for K2's staged table windows
K2_SLOT_BUDGET = 64 * 1024  # shared memory for K2's uint16 slot tables


def k2_slots_in_smem(r: int, m: int, v_max: int) -> bool:
    """Whether K2 copies the ``[r, m]`` slot tables into shared memory as
    uint16: every slot must fit 16 bits (``V < 2^16``) and the tables
    ``K2_SLOT_BUDGET`` bytes; otherwise the kernel reads them in place."""
    return v_max < 1 << 16 and 2 * r * m <= K2_SLOT_BUDGET


def k2_staged_rows(wlen, budget: int, itemsize: int = 4) -> tuple:
    """The rows whose table windows K2 stages: rows 0 and 1 (the narrowest
    riffles) when both windows, ``itemsize`` bytes an entry (the table's
    type), fit ``budget`` bytes together, else none (the kernel fixes the
    count at compile time)."""
    if len(wlen) >= 2 and itemsize * (int(wlen[0]) + int(wlen[1])) <= budget:
        return (0, 1)
    return ()


K2R_WINDOW_BUDGET = 64 * 1024  # bytes of a row-pass block's table window


def k2_rows_window(lg: int, f: int, m: int, s: int, V: int) -> int:
    """Table entries that a row-pass block of ``kc = 32 << lg`` consecutive
    c of a row's [f, G] view reads at most: its riffled positions span
    ``kc * f``, so at most ``ceil(kc * f / m) + 1`` chunks. The same bound
    as ``cs_estimate_rows`` in ``csrc/riffle.cu``."""
    kc = 32 << lg
    return (-(-kc * f // m) + 1) * s + V


def k2_rows_lg(f: int, G: int, m: int, s: int, V: int, itemsize: int,
               budget: int = K2R_WINDOW_BUDGET):
    """``lg`` of a row's row-pass tiles (``kc = 32 << lg`` c values): the
    largest whose window, ``itemsize`` bytes an entry, fits ``budget``, and
    no wider than the row's G needs; None where not even 32 fit."""
    if itemsize * k2_rows_window(0, f, m, s, V) > budget:
        return None
    lg = 0
    while (32 << lg) < G and itemsize * k2_rows_window(lg + 1, f, m, s, V) \
            <= budget:
        lg += 1
    return lg


def k2_design(r: int, table_bytes: int, walk_slot_smem: bool, row_lgs,
              slot_smem: bool, row0_window: int, itemsize: int) -> tuple:
    """``(design, nt)``: which K2 kernels a geometry takes. Where the
    table fits the L2 and the walk keeps every row's slot table in shared
    memory (``walk_slot_smem``), the walk (``"walk"``: its scattered reads
    hit L2 and its slots cost no load); else the row design (``"rows"``)
    if every row has a row-pass tile (``row_lgs``, None where none fits),
    with row 0 read by the final walk from its staged window (nt = 1: its
    slot table fits uint16, ``slot_smem``, and ``row0_window`` entries
    fit ``K2_WINDOW_BUDGET``) or through the pass like the others (nt =
    0). ResNet-9 takes the walk; FixupResNet-50 (m = 8192: the five slot
    tables take 80 KB) and GPT-2 (a 100 MB table) the row design."""
    if r < 2 or (table_bytes <= L2_BYTES and walk_slot_smem) \
            or any(lg is None for lg in row_lgs[1:]):
        return "walk", r
    if slot_smem and itemsize * row0_window <= K2_WINDOW_BUDGET:
        return "rows", 1
    if row_lgs[0] is None:
        return "walk", r
    return "rows", 0


def k2_smem_bytes(r: int, m: int, slot_smem: bool, blocks_per_tile: int,
                  window_entries: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one K2 block: the uint16 slot tables when
    they are staged, the tile's scramble-block offsets (uint32), then the
    windows in the table's type (``itemsize`` bytes an entry), each part
    padded to 16 bytes. Same layout as ``cs_estimate_median`` in
    ``csrc/walk.cu``."""
    return ((_align16(2 * r * m) if slot_smem else 0)
            + _align16(4 * blocks_per_tile) + itemsize * window_entries)

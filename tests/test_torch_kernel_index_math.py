"""The CUDA kernels' index arithmetic, held on the CPU at tiny sizes.

The kernels run only on the card; what they compute about indices is
planned on the host in ``ops/cuda/index_math.py``, or mirrored here:

* the multiplier and shift that replace each runtime division (exact
  ``//`` for every dividend the kernel admits, up to the 2^32 layout
  guard; the device formula emulated with Python ints);
* a mirror of K1's tile walk (every (row, column) summed exactly once,
  over exactly the chunks whose window covers it, in ascending order) and
  of its staging order (each chunk's positions once, neighbouring slots
  reading neighbouring positions); a float32 replay of the walk equals
  the gather kernel's summation order bit for bit;
* K4's range form: the scramble blocks of a slice in scrambled order, and
  the table windows that each CUDA block reads;
* a mirror of K1's segment form: the pairs' keys, the tile buckets of the
  scatter pass over pieces and windows, the owner pass's partition and
  the order of each column's sums, and the small path, held to the plain
  version; its tile width and scratch at the main geometries;
* a mirror of K2's walk over every coordinate: the staged windows hold
  every column a tile reads, the fused unscramble writes each coordinate
  below d exactly once and skips the padding, and a float32 replay equals
  the plain version bit for bit; K2's slot tables and packed sign bits
  against the spec's hashes (and the sign bits against the JAX
  reference's in-kernel sign hash).

No card: exact integer comparisons, and the plain versions as the float
reference. Only the sign-bit test imports the JAX reference.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from commefficient_tpu_torch.ops import countsketch as cs
from commefficient_tpu_torch.ops.cuda import build, index_math
from commefficient_tpu_torch.ops.cuda import countsketch as kern

SPECS = [
    # (d, c, r, band, m, seed): ResNet-9's main path, the geometries of
    # tests/test_torch_cuda_kernels.py (K1/K2 and K4), one with m = 32768
    # (the gather kernel's side of the tile-width rule)
    (6_573_130, 500_000, 5, 16, None, 42),
    (20_011, 4_000, 3, 16, 512, 42),
    (212, 512, 4, 16, None, 42),
    (1_200_003, 48_000, 8, 8, None, 42),
    (1_200_003, 1_100_000, 3, 16, None, 11),
    (50_011, 8_000, 5, 16, None, 7),
    (10_000, 2_000, 5, 16, None, 7),
    (124_439_808, 1_000_000, 5, 16, None, 42),
]


def _spec(d, c, r, band, m, seed):
    return cs.CountSketch(d=d, c=c, r=r, band=band, m=m, seed=seed)


def _edges(d: int, n_max: int):
    """Dividends at the edges of the quotient steps: k*d - 1, k*d, k*d + 1
    for the first, a middle and the last multiples up to n_max."""
    ks = {0, 1, 2, n_max // d // 2, n_max // d - 1, n_max // d}
    out = {0, 1, n_max - 1, n_max}
    for k in ks:
        out.update({k * d - 1, k * d, k * d + 1})
    return sorted(n for n in out if 0 <= n <= n_max)


# -- divisions by multiplier ----------------------------------------------------


@pytest.mark.parametrize("geo", SPECS, ids=lambda g: f"d{g[0]}_c{g[1]}")
def test_kernel_divisors_exact_at_edges_and_in_bulk(geo):
    spec = _spec(*geo)
    params = spec.kernel_row_params()
    rng = np.random.default_rng(0)
    for row in range(spec.r):
        divs = spec.kernel_divisors(row)
        for k, name in enumerate(cs.DIVISORS):
            d, n_max = divs[name]
            mul, shift = params[row, cs.RP_DIV + 2 * k:cs.RP_DIV + 2 * k + 2]
            mul, shift = int(mul), int(shift)
            assert (mul, shift) == index_math.fast_divisor(d, n_max)
            assert n_max < 2**32 and (shift == index_math.SHIFT_WIDE
                                      or mul < 2**32)
            ns = _edges(d, n_max) + [int(x) for x in rng.integers(
                0, n_max + 1, size=2000, dtype=np.int64)]
            got = [index_math.udiv(n, mul, shift) for n in ns]
            assert got == [n // d for n in ns], (row, name, d, n_max)


@settings(max_examples=200, deadline=None, database=None)
@given(data=st.data())
def test_kernel_divisors_exact_for_drawn_dividends(data):
    spec = _spec(*data.draw(st.sampled_from(SPECS)))
    row = data.draw(st.integers(0, spec.r - 1))
    name = data.draw(st.sampled_from(cs.DIVISORS))
    d, n_max = spec.kernel_divisors(row)[name]
    mul, shift = index_math.fast_divisor(d, n_max)
    n = data.draw(st.integers(0, n_max))
    assert index_math.udiv(n, mul, shift) == n // d


@settings(max_examples=300, deadline=None, database=None)
@given(d=st.integers(1, 2**32 - 1), n_max=st.integers(0, 2**32 - 1),
       data=st.data())
def test_fast_divisor_exact_for_any_32bit_divisor(d, n_max, data):
    mul, shift = index_math.fast_divisor(d, n_max)
    assert shift == index_math.SHIFT_WIDE or mul < 2**32
    for n in _edges(d, n_max) + [data.draw(st.integers(0, n_max))]:
        assert index_math.udiv(n, mul, shift) == n // d


def test_fast_divisor_takes_the_wide_form_only_where_it_must():
    # 4992 (a ResNet-9 window) with 32-bit hash dividends: no narrow shift
    # is exact up to 2^32 - 1, so the wide multiply-high form is used
    assert index_math.fast_divisor(4992, 2**32 - 1)[1] == \
        index_math.SHIFT_WIDE
    assert index_math.fast_divisor(4096, 2**32 - 1) == (1, 12)
    assert index_math.fast_divisor(1, 2**32 - 1) == (1, 0)
    with pytest.raises(ValueError, match="divisor"):
        index_math.fast_divisor(0, 10)
    with pytest.raises(ValueError, match="dividend"):
        index_math.fast_divisor(3, 2**32)


# -- K1: the tile walk and its staging order ---------------------------------


def tile_chunks(j0, ncols, s, V, nc):
    """Mirror of ``cs_sketch_tiles_kernel``'s chunk range: the chunks whose
    windows ``[q*s, q*s + V)`` meet the tile's columns ``[j0, j0 +
    ncols)``, empty (q_lo > q_hi) past the row's end."""
    q_hi = min(nc - 1, (j0 + ncols - 1) // s)
    q_lo = 0 if j0 + 1 <= V else (j0 + s - V) // s
    return q_lo, q_hi


def stage_positions(q, m, f, G):
    """Mirror of the kernel's staging walk for chunk q: ``(o, i)`` int64
    [m], the within-chunk offset that thread slot k fills and the
    scrambled position it reads. Residue by residue (p mod f), rotated to
    start at the chunk's first residue: the first ``m mod f`` residues hold
    ``m div f + 1`` positions, the rest ``m div f``."""
    k = np.arange(m, dtype=np.int64)
    mq, mr = divmod(m, f)
    nbig = mr * (mq + 1)
    big = k < nbig
    r = np.where(big, k // (mq + 1), mr + (k - nbig) // max(mq, 1))
    j = np.where(big, k - r * (mq + 1), k - nbig - (r - mr) * mq)
    c0, a0 = divmod(q * m, f)
    a = a0 + r
    wrap = a >= f
    a = np.where(wrap, a - f, a)
    return r + j * f, a * G + c0 + wrap + j


def _row_geo(spec, row):
    f, L = spec._factor(row), spec._L_row(row)
    return dict(f=f, G=L // f, m=spec.chunk_m, s=spec.s_row(row),
                V=spec.V_row(row), nc=L // spec.chunk_m,
                rowlen=(L // spec.chunk_m + spec.u_row(row) - 1)
                * spec.s_row(row))


def _walk_counts(spec, row, W):
    """The kernel's tile walk for one row, as (visits per column, whether
    every visited (column, chunk) pair lies in the chunk's window): tiles
    of W strides over [0, c_actual), each over its chunk range and, per
    chunk, the tile's columns inside the window."""
    g = _row_geo(spec, row)
    s, V, nc, c = g["s"], g["V"], g["nc"], spec.c_actual
    visits = np.zeros(c, np.int64)
    for j0 in range(0, c, W * s):
        ncols = min(W * s, c - j0)
        q_lo, q_hi = tile_chunks(j0, ncols, s, V, nc)
        for q in range(q_lo, q_hi + 1):
            c_lo = max(q * s - j0, 0)
            c_hi = min(ncols, q * s + V - j0)
            assert 0 <= c_lo < c_hi <= ncols, (j0, q)
            visits[j0 + c_lo:j0 + c_hi] += 1
    return visits, g


@pytest.mark.parametrize("W", [1, 3, 8, 32])
@pytest.mark.parametrize("geo", SPECS[:4], ids=lambda g: f"d{g[0]}")
def test_tile_walk_covers_each_column_over_its_chunks_once(geo, W):
    spec = _spec(*geo)
    for row in range(spec.r):
        visits, g = _walk_counts(spec, row, W)
        j = np.arange(spec.c_actual)
        q_hi = np.minimum(g["nc"] - 1, j // g["s"])
        q_lo = np.where(j - g["V"] + 1 <= 0, 0,
                        -(-(j - g["V"] + 1) // g["s"]))
        want = np.where(j < g["rowlen"], np.maximum(q_hi - q_lo + 1, 0), 0)
        np.testing.assert_array_equal(visits, want)


def test_tile_geometries_include_the_edge_cases():
    """The walk above covers a row shorter than its band (u < band), a
    table whose width is not a multiple of the tile, and the tile-width
    rule picks the gather kernel where a chunk exceeds the tile's
    per-thread capacity (m = 32768)."""
    small = _spec(*SPECS[2])
    assert any(small.u_row(r) < small.band for r in range(small.r))
    main = _spec(*SPECS[0])
    W = kern._kernel_geometry(main, "cpu")[3]
    assert W == 32 and any(main.c_actual % (W * main.s_row(r))
                           for r in range(main.r))
    big = _spec(*SPECS[-1])
    assert big.chunk_m == 32768
    assert index_math.sketch_tile_strides(
        [(big.chunk_m, big.s_row(r), big.V_row(r))
         for r in range(big.r)]) == 0


@pytest.mark.parametrize("geo", SPECS[:4], ids=lambda g: f"d{g[0]}")
def test_stage_order_covers_each_chunk_once_in_runs(geo):
    spec = _spec(*geo)
    for row in range(spec.r):
        g = _row_geo(spec, row)
        for q in sorted({0, 1, g["nc"] // 2, g["nc"] - 1} & set(
                range(g["nc"]))):
            o, i = stage_positions(q, g["m"], g["f"], g["G"])
            np.testing.assert_array_equal(np.sort(o), np.arange(g["m"]))
            p = q * g["m"] + o
            np.testing.assert_array_equal(i, (p % g["f"]) * g["G"]
                                          + p // g["f"])
            breaks = int(np.count_nonzero(np.diff(i) != 1))
            assert breaks <= min(g["f"], g["m"]) - 1


def _k1_replay(spec, v_s, W):
    """float32 replay of ``cs_sketch_tiles_kernel``: each tile's chunks in
    ascending q, each chunk staged in CSR order (signed, +0 past d_eff),
    each column summing its slot's run of the stage."""
    ptr_all, off_all = (t.numpy() for t in spec.csr_tables("cpu"))
    v = v_s.numpy()
    table = np.zeros(spec.table_shape, np.float32)
    ptr_base = 0
    for row in range(spec.r):
        g = _row_geo(spec, row)
        m, s, V = g["m"], g["s"], g["V"]
        ptr = ptr_all[ptr_base:ptr_base + V + 1]
        off = off_all[row * m:(row + 1) * m]
        ptr_base += V + 1
        for j0 in range(0, spec.c_actual, W * s):
            ncols = min(W * s, spec.c_actual - j0)
            acc = np.zeros(ncols, np.float32)
            q_lo, q_hi = tile_chunks(j0, ncols, s, V, g["nc"])
            for q in range(q_lo, q_hi + 1):
                o, i = stage_positions(q, m, g["f"], g["G"])
                val = np.zeros(m, np.float32)
                ok = i < spec.d_eff
                sign = 1.0 - 2.0 * spec.sign_bits(
                    row, torch.from_numpy(i[ok])).numpy()
                val[o[ok]] = v[i[ok]] * sign.astype(np.float32)
                stage = val[off]  # CSR order
                for c in range(max(q * s - j0, 0), min(ncols, q * s + V - j0)):
                    t = j0 + c - q * s
                    a = acc[c]
                    for e in range(ptr[t], ptr[t + 1]):
                        a = np.float32(a + stage[e])
                    acc[c] = a
            table[row, j0:j0 + ncols] = acc
    return table


def _k1_gather(spec, v_s):
    """float32 replay of the gather kernel: per column, chunks ascending,
    offsets ascending, positions past d_eff skipped."""
    ptr_all, off_all = (t.numpy() for t in spec.csr_tables("cpu"))
    v = v_s.numpy()
    table = np.zeros(spec.table_shape, np.float32)
    ptr_base = 0
    for row in range(spec.r):
        g = _row_geo(spec, row)
        m, s, V, f, G = g["m"], g["s"], g["V"], g["f"], g["G"]
        ptr = ptr_all[ptr_base:ptr_base + V + 1]
        off = off_all[row * m:(row + 1) * m]
        ptr_base += V + 1
        for j in range(min(g["rowlen"], spec.c_actual)):
            a = np.float32(0.0)
            q_lo = 0 if j - V + 1 <= 0 else -(-(j - V + 1) // s)
            for q in range(q_lo, min(g["nc"] - 1, j // s) + 1):
                for e in range(ptr[j - q * s], ptr[j - q * s + 1]):
                    p = q * m + int(off[e])
                    i = (p % f) * G + p // f
                    if i < spec.d_eff:
                        sgn = 1 - 2 * int(spec.sign_bits(
                            row, torch.tensor([i]))[0])
                        a = np.float32(a + np.float32(sgn) * v[i])
            table[row, j] = a
    return table


@pytest.mark.parametrize("W", [2, 32])
def test_k1_replay_equals_gather_order_bit_for_bit(W):
    """d = 212 (u < band, a chunk larger than d, padding past d_eff)."""
    spec = cs.CountSketch(d=212, c=512, r=4)
    v = torch.from_numpy(np.random.default_rng(3).normal(
        size=spec.d).astype(np.float32))
    v_s = cs._scramble(spec, v)
    tiles = _k1_replay(spec, v_s, W)
    np.testing.assert_array_equal(tiles, _k1_gather(spec, v_s))
    want = kern.sketch_rows_torch(spec, v_s).numpy()
    np.testing.assert_allclose(tiles, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


# -- K1's segment form: keys, buckets, windows and the order of the sums --


def _segment_keys(spec, row, x):
    """The kernel's pair of each original coordinate ``x`` (int64) in
    ``row``: its scrambled position through the inverse block permutation,
    then the riffle, chunk, slot and column (``cs_col``) and the sign bit
    (``cs_sign_hash``)."""
    b = spec.sblock
    i = spec.inverse_block_perm()[x // b].astype(np.int64) * b + x % b \
        if b else x
    f, m, s = spec._factor(row), spec.chunk_m, spec.s_row(row)
    G = spec._L_row(row) // f
    hi = i // G
    p = (i - hi * G) * f + hi
    q = p // m
    slot = spec.slot_hash(row, torch.from_numpy(p - q * m)).numpy()
    neg = spec.sign_bits(row, torch.from_numpy(i)).numpy().astype(bool)
    return q * s + slot, neg


def _segment_stream(col, shift, ntiles, t):
    """The scatter pass (per piece of ``SEG_PIECE`` values, the pairs
    stably bucketed by tile, with the piece's tile starts) and the owner
    pass's gather for tile ``t`` (each piece's run, in piece order):
    tile ``t``'s stream of window-local value indices."""
    runs = []
    for a in range(0, len(col), index_math.SEG_PIECE):
        tile = col[a:a + index_math.SEG_PIECE] >> shift
        order = np.argsort(tile, kind="stable")
        starts = np.searchsorted(tile[order], np.arange(ntiles + 1))
        runs.append(a + order[starts[t]:starts[t + 1]])
    return np.concatenate(runs)


def _segment_partition(stream, col, shift):
    """The owner's sub-batches of ``SEG_BATCH`` pairs, each stably
    partitioned by bin (``SEG_OWNER_THREADS`` bins of T / 256 columns, one
    an owner thread): the order in which each thread adds its pairs."""
    out = []
    bits = index_math.SEG_OWNER_THREADS.bit_length() - 1
    for a in range(0, len(stream), index_math.SEG_BATCH):
        sub = stream[a:a + index_math.SEG_BATCH]
        b = (col[sub] & ((1 << shift) - 1)) >> (shift - bits)
        out.append(sub[np.argsort(b, kind="stable")])
    return np.concatenate(out) if out else stream


def _segment_replay(spec, offset, vals, capacity=None, small=None):
    """A mirror of ``cs_sketch_segment`` (``csrc/segment.cu``): a leaf of at
    most ``SEG_PIECE`` values takes the small path (per row, the pairs
    sorted stably by column), a larger one ``index_math.segment_windows``
    for a scratch of ``capacity`` piece-rows (default
    ``index_math.segment_capacity``), each window through the scatter and
    owner passes at its row group's tile width. Per window and row, each
    column's pairs are summed in float32 in that order from -0.0, and the
    sum is added to the table unless it is -0.0. Returns (the table, the
    set of (row, column) entries written); asserts on the way that every
    column's pairs come in the leaf's order."""
    v = vals.numpy()
    n = v.size
    small = index_math.segment_small(n) if small is None else small
    shifts = index_math.segment_shifts(spec.r, spec.c_actual)
    capacity = capacity or index_math.segment_capacity(
        spec.r, spec.d, -(-spec.c_actual >> shifts[0]))
    windows = [(0, spec.r, 0, n)] if small else index_math.segment_windows(
        spec.r, n, capacity)
    table = np.zeros(spec.table_shape, np.float32)
    written = set()
    for row0, g, k0, wn in windows:
        shift = shifts[g - 1]
        ntiles = -(-spec.c_actual >> shift)
        k = np.arange(k0, k0 + wn)
        for row in range(row0, row0 + g):
            col, neg = _segment_keys(spec, row, offset + k)
            sv = np.where(neg, -v[k], v[k]).astype(np.float32)
            if small:
                order = [np.argsort(col, kind="stable")]
            else:
                order = [_segment_partition(_segment_stream(col, shift, ntiles,
                                                            t), col, shift)
                         for t in range(ntiles)]
            for o in order:
                for c in np.unique(col[o]):  # the leaf's order per column
                    assert np.all(np.diff(o[col[o] == c]) > 0)
            o = np.concatenate(order)
            acc = np.full(spec.c_actual, -0.0, np.float32)
            np.add.at(acc, col[o], sv[o])  # in order, in float32
            hit = acc.view(np.uint32) != np.float32(-0.0).view(np.uint32)
            table[row, hit] += acc[hit]
            written |= {(row, int(c)) for c in np.flatnonzero(hit)}
    return table, written


SEGMENTS = {  # (d, c, r, family) -> segments (offset, n)
    (212, 512, 4, "fmix32"): [(0, 1), (0, 212), (60, 63), (147, 65)],
    (3_001, 600, 3, "poly4"): [(63, 1), (64, 64), (100, 65), (2_936, 65)],
    (3_001, 600, 1, "fmix32"): [(1, 63), (2_999, 2)],
    # the small path's limit and one past it, a leaf ending at d, the
    # whole vector
    (20_011, 4_000, 3, "fmix32"): [(0, 8_192), (5, 8_193),
                                   (11_011, 9_000), (0, 20_011)],
    (20_011, 4_000, 5, "poly4"): [(37, 8_192), (100, 8_193),
                                  (2_011, 18_000)],
}


@pytest.mark.parametrize("geo", sorted(SEGMENTS), ids=str)
def test_segment_replay_equals_plain_version(geo):
    """Leaves of 1, 63, 64 and 65 values, offsets that straddle a scramble
    block, leaves at the small path's limit (8192) and one past it, leaves
    ending at d (inside d_eff's padding), r of 1, 3, 4 and 5, both hash
    families: the kernel's passes reach every value of the segment once
    (the plain version's table to 1e-6, the order of the sums aside; the
    kernel's own bound is ``1e-5 * max|table|``) and write exactly the
    entries the segment touches."""
    d, c, r, family = geo
    spec = cs.CountSketch(d=d, c=c, r=r, hash_family=family, seed=5)
    rng = np.random.default_rng(1)
    for offset, n in SEGMENTS[geo]:
        vals = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        got, written = _segment_replay(spec, offset, vals)
        want = kern.sketch_segment_torch(
            spec, offset, vals, torch.zeros(spec.table_shape)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        spos = spec.scrambled_pos(offset + torch.arange(n))
        touched = {(row, int(col)) for row in range(r)
                   for col in spec.scrambled_cols_signs(row, spos)[0]}
        assert written == touched, (offset, n)


@pytest.mark.parametrize("capacity,windows", [
    (1, [(0, 1, 0, 8_192), (0, 1, 8_192, 8_192), (0, 1, 16_384, 7)]),
    (2, [(0, 1, 0, 16_384), (0, 1, 16_384, 7)]),
    (6, [(0, 2, 0, 16_391), (2, 1, 0, 16_391)]),
])
def test_segment_replay_over_windows_and_row_groups(capacity, windows):
    """A leaf of 2 * 8192 + 7 values (three pieces) through scratches of one,
    two and six piece-rows: each row alone in three and in two windows of
    values, then the rows in groups of two; each window adds its own sums
    into the table, which is the plain version's."""
    spec = cs.CountSketch(d=20_011, c=4_000, r=3, seed=5)
    n = 2 * index_math.SEG_PIECE + 7
    plan = index_math.segment_windows(spec.r, n, capacity)
    assert plan[:len(windows)] == windows
    assert len(plan) == (3 * len(windows) if windows[0][1] == 1 else 2)
    vals = torch.from_numpy(np.random.default_rng(2).normal(
        size=n).astype(np.float32))
    got, written = _segment_replay(spec, 1_000, vals, capacity=capacity)
    want = kern.sketch_segment_torch(
        spec, 1_000, vals, torch.zeros(spec.table_shape)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert len(written) == np.count_nonzero(want)


def test_segment_small_path_equals_the_two_passes_at_its_limit():
    """At n = 8192 the small path and the two passes (one window) sum every
    column in the same order: bit-equal tables."""
    spec = cs.CountSketch(d=20_011, c=4_000, r=3, seed=5)
    n = index_math.SEG_PIECE
    assert index_math.segment_small(n)
    assert not index_math.segment_small(n + 1)
    vals = torch.from_numpy(np.random.default_rng(3).normal(
        size=n).astype(np.float32))
    small, w1 = _segment_replay(spec, 300, vals, small=True)
    two, w2 = _segment_replay(spec, 300, vals, small=False)
    np.testing.assert_array_equal(small, two)
    assert w1 == w2


@pytest.mark.parametrize("geo,shifts,capacity", [
    # ResNet-9's and GPT-2's FetchSGD geometries
    ((6_573_130, 500_000, 5), [9, 10, 11, 11, 12], 1_263),
    ((124_444_417, 5_000_000, 5), [13, 13, 13, 13, 13], 1_300),
    ((212, 512, 4), [8, 8, 8, 8], 4),
])
def test_segment_plan_at_the_main_geometries(geo, shifts, capacity):
    """The tile width gives at least ``SEG_MIN_BUCKETS`` owner blocks a
    launch where the table is wide enough, and the scratch stays within
    64 MiB; GPT-2's ``wte`` goes a row at a time, ResNet-9's largest
    leaves in row groups of three and two."""
    d, c, r = geo
    spec = cs.CountSketch(d=d, c=c, r=r)
    got = index_math.segment_shifts(r, spec.c_actual)
    ntiles = -(-spec.c_actual >> got[0])
    assert got == shifts
    assert index_math.segment_capacity(r, d, ntiles) == capacity
    assert ntiles <= index_math.SEG_MAX_TILES
    for g, shift in enumerate(shifts, 1):
        if shift > 8:
            assert g * -(-spec.c_actual >> shift) \
                >= index_math.SEG_MIN_BUCKETS
        if shift < 13:  # a wider tile would give too few
            assert g * -(-spec.c_actual >> (shift + 1)) \
                < index_math.SEG_MIN_BUCKETS
    assert index_math.segment_scratch_bytes(capacity, ntiles) \
        <= index_math.SEG_SCRATCH_BUDGET
    if d == 124_444_417:
        w = index_math.segment_windows(r, 38_601_216, capacity)
        assert len(w) == 20 and {x[1] for x in w} == {1}
    if d == 6_573_130:
        assert index_math.segment_windows(r, 2_359_296, capacity) == [
            (0, 3, 0, 2_359_296), (3, 2, 0, 2_359_296)]
    with pytest.raises(ValueError, match="at most"):
        index_math.segment_tile_shift(1, 1024 * 16384 + 1)


# -- K4: the range form's block order and windows ---------------------------


def _slices(d):
    S = -(-d // 4)
    return [(0, d), (0, 1), (17, 1000), (S, S), (3 * S, S), (d - 5, 64),
            (d + 3, 7)]


@pytest.mark.parametrize("geo", SPECS[:7], ids=lambda g: f"d{g[0]}")
def test_range_block_list_is_the_slice_in_scrambled_order(geo):
    spec = _spec(*geo)
    b, inv = spec.sblock, spec.inverse_block_perm()
    for start, n in _slices(spec.d):
        blocks = index_math.range_block_list(inv, b, start, n, spec.d)
        xs = np.minimum(start + np.arange(n), spec.d - 1)
        np.testing.assert_array_equal(np.sort(blocks),
                                      np.unique(xs // b))  # ragged ends too
        assert np.all(np.diff(inv[blocks]) > 0)
        xa, xb = index_math.range_span(start, n, spec.d)
        assert (xa, xb) == (xs.min(), xs.max())


@pytest.mark.parametrize("geo", SPECS[:7], ids=lambda g: f"d{g[0]}")
def test_range_windows_cover_every_column_a_block_reads(geo):
    spec = _spec(*geo)
    b, inv = spec.sblock, spec.inverse_block_perm()
    geo_rows = [tuple(_row_geo(spec, r)[k] for k in "fGmsV")
                for r in range(spec.r)]
    per_block = max(1, index_math.K4R_COORDS // b)
    for start, n in _slices(spec.d)[::2]:
        blocks = index_math.range_block_list(inv, b, start, n, spec.d)
        wstart, wlen = index_math.range_windows(blocks, inv, b, start, n,
                                                spec.d, geo_rows, per_block)
        xa, xb = index_math.range_span(start, n, spec.d)
        x = (blocks.astype(np.int64)[:, None] * b + np.arange(b)).ravel()
        blk = np.repeat(np.arange(len(blocks)) // per_block, b)
        keep = (x >= xa) & (x <= xb)
        spos = spec.scrambled_pos(torch.from_numpy(x[keep]))
        for row in range(spec.r):
            cols = spec.scrambled_cols_signs(row, spos)[0].numpy()
            rel = cols - wstart[blk[keep], row]
            assert rel.min() >= 0 and rel.max() < wlen[row], (start, n, row)
    staged = index_math.range_staged_rows(wlen, 48 * 1024)
    assert 4 * sum(int(wlen[r]) for r in staged) <= 48 * 1024


def test_range_plan_on_the_main_path_stages_the_narrow_rows():
    """At every coordinate of the ResNet-9 geometry the f = 1 and f = 7
    windows fit the shared-memory budget; the wide-riffle rows read the
    table in place."""
    spec = _spec(*SPECS[0])
    plan = kern._range_plan(spec, 0, spec.d, "cpu")
    assert plan["staged"] == (0, 1)
    assert plan["blocks"].numel() == spec.d_eff // spec.sblock


# -- K2: the walk over every coordinate ---------------------------------------

K2_SPECS = [
    # (d, c, r, band, m, scramble_block): the main path, the small
    # geometries of tests/test_torch_cuda_kernels.py, two without the
    # scramble (one of them a d that is not a multiple of the tile), and
    # one whose divisions by m and b cannot be shifts
    (6_573_130, 500_000, 5, 16, None, None),
    (20_011, 4_000, 3, 16, 512, None),
    (212, 512, 4, 16, None, None),
    (1_200_003, 48_000, 8, 8, None, None),
    (20_011, 4_000, 3, 16, 512, 0),
    (50_011, 8_000, 5, 16, None, 0),
    # m = 1000 and a scramble block of 15: neither is a power of two
    (20_011, 4_000, 3, 16, 1000, None),
]


def _k2_spec(d, c, r, band, m, sb, family="fmix32"):
    return cs.CountSketch(d=d, c=c, r=r, band=band, m=m, scramble_block=sb,
                          hash_family=family)


def k2_walk(spec, plan):
    """Mirror of ``cs_estimate_median_kernel``'s index arithmetic with the
    kernel's own divisions (``udiv`` with the row parameters): per tile,
    each row's ``(i0 div G, i0 mod G)`` and the scramble blocks' offsets
    ``x - i``; per position, the riffle from those (a division only where
    the tile crosses a multiple of G). Returns ``(tile, i, x, cols [r,
    n])`` for every scrambled position ``i < d_eff`` the tiles walk, ``x``
    the original coordinate it is written to."""
    P = spec.kernel_row_params()

    def div(n, row, name):
        k = cs.RP_DIV + 2 * cs.DIVISORS.index(name)
        return index_math.udiv(n, int(P[row, k]), int(P[row, k + 1]))

    per_tile, ntiles, m, b = (plan["per_tile"], plan["ntiles"],
                              spec.chunk_m, plan["b"])
    i = np.arange(min(ntiles * per_tile, spec.d_eff), dtype=np.int64)
    tile = i // per_tile
    i0, k = tile * per_tile, i % per_tile
    x = i
    if plan["perm"] is not None:
        sb = (i0 // per_tile) * (per_tile // b) + div(k, 0, "sblock")
        perm = plan["perm"].numpy().astype(np.int64)
        x = (i + ((perm[sb] - sb) * b) % 2**32) % 2**32  # uint32 wrap
    slots = plan["slots"].numpy().astype(np.int64)
    cols = np.empty((spec.r, i.size), np.int64)
    for row in range(spec.r):
        f, G, s = (int(P[row, c]) for c in (cs.RP_F, cs.RP_G, cs.RP_S))
        hi0 = div(i0, row, "G")
        hi, r = hi0, i0 - hi0 * G + k
        cross = r >= G  # the tile crosses a multiple of G here
        hi = np.where(cross, div(i, row, "G"), hi)
        r = np.where(cross, i - hi * G, r)
        p = r * f + hi
        q = p >> (m.bit_length() - 1) if m & (m - 1) == 0 else div(p, row, "m")
        cols[row] = q * s + slots[row, p - q * m]
    return tile, i, x, cols


@pytest.mark.parametrize("geo", K2_SPECS, ids=lambda g: f"d{g[0]}_sb{g[5]}")
def test_k2_walk_stays_in_its_windows_and_unscrambles_once(geo):
    spec = _k2_spec(*geo)
    plan = kern._k2_plan(spec, "cpu")
    assert plan["ntiles"] * plan["per_tile"] >= spec.d_eff
    assert (plan["perm"] is None) == (not spec.sblock)
    tile, i, x, cols = k2_walk(spec, plan)
    assert i.size == spec.d_eff  # every scrambled position, once
    keep = x < spec.d  # the kernel skips the padding past d
    assert int((~keep).sum()) == spec.d_eff - spec.d
    np.testing.assert_array_equal(np.sort(x[keep]), np.arange(spec.d))
    # the column each position reads is the plain version's
    spos = spec.scrambled_pos(torch.from_numpy(x[keep]))
    np.testing.assert_array_equal(spos.numpy(), i[keep])
    wstart = plan["wstart"].numpy().astype(np.int64)
    wlen_all = plan["wlen_all"]
    for row in range(spec.r):
        np.testing.assert_array_equal(
            cols[row, keep], spec.scrambled_cols_signs(row, spos)[0].numpy())
        rel = cols[row, keep] - wstart[tile[keep], row]
        assert rel.min() >= 0 and rel.max() < wlen_all[row], row
        if row in plan["staged"]:
            assert rel.max() < plan["wlen"][row]
            assert plan["woff"][row] + plan["wlen"][row] <= \
                index_math.K2_WINDOW_BUDGET // 4
    assert plan["smem_bytes"] <= index_math.K1_SMEM_LIMIT // 2


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("geo", K2_SPECS[1:], ids=lambda g: f"d{g[0]}_sb{g[5]}")
def test_k2_replay_equals_plain_version_bit_for_bit(geo, family):
    """float32 replay of the kernel: the mirrored columns, the packed sign
    bits, the median network, written at x; equal to the plain version
    (the gather, the median, the unscramble)."""
    spec = _k2_spec(*geo, family=family)
    plan = kern._k2_plan(spec, "cpu")
    table = torch.from_numpy(np.random.default_rng(geo[0]).normal(
        size=spec.table_shape).astype(np.float32))
    _, i, x, cols = k2_walk(spec, plan)
    keep = x < spec.d
    words = plan["signs"].numpy().view(np.uint32).astype(np.int64)
    ests = []
    for row in range(spec.r):
        neg = (words[row, i >> 5] >> (i & 31)) & 1
        v = table[row][torch.from_numpy(cols[row])]
        ests.append(v * torch.from_numpy(1.0 - 2.0 * neg).float())
    med = kern._median_network(ests)
    out = torch.empty(spec.d)
    out[torch.from_numpy(x[keep])] = med[torch.from_numpy(keep)]
    assert torch.equal(out, kern.estimate_median_torch(spec, table))


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_k2_slot_tables_equal_the_slot_hash(family):
    for geo in K2_SPECS:
        spec = _k2_spec(*geo, family=family)
        plan = kern._k2_plan(spec, "cpu")
        for row in range(spec.r):
            want = spec.slot_hash(row, torch.arange(spec.chunk_m))
            np.testing.assert_array_equal(plan["slots"][row].numpy(), want)
        if plan["slot_smem"]:  # uint16 in shared memory loses nothing
            assert int(plan["slots"].max()) < 2**16
    main = kern._k2_plan(_k2_spec(*K2_SPECS[0], family=family), "cpu")
    assert main["slot_smem"] and main["staged"] == (0, 1)
    assert main["smem_bytes"] == 2 * 5 * 4096 + 4 * 64 + 4 * sum(main["wlen"])
    # m = 32768 (the 124M geometry) or V >= 2^16: read in place
    assert not index_math.k2_slots_in_smem(5, 32768, 4992)
    assert not index_math.k2_slots_in_smem(1, 512, 2**16)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_packed_sign_bits_equal_the_sign_hash_and_the_reference(family):
    from commefficient_tpu.ops import countsketch as ref
    from commefficient_tpu.ops.pallas.countsketch_kernels import _row_hashes
    import jax.numpy as jnp

    d, c, r = 20_011, 4_000, 3
    spec = cs.CountSketch(d=d, c=c, r=r, m=512, hash_family=family)
    ref_spec = ref.CountSketch(d=d, c=c, r=r, m=512, hash_family=family,
                               backend="pallas")
    words = kern.packed_sign_bits(spec, "cpu")
    assert words.shape == (r, -(-spec.d_eff // 32))
    w = words.numpy().view(np.uint32).astype(np.int64)
    pos = np.arange(w.shape[1] * 32)
    rng = np.random.default_rng(1)
    at = np.sort(rng.choice(spec.d_eff, size=2000, replace=False))
    for row in range(r):
        bits = (w[row, pos >> 5] >> (pos & 31)) & 1
        want = spec.sign_bits(row, torch.arange(spec.d_eff)).numpy()
        np.testing.assert_array_equal(bits[:spec.d_eff], want)
        assert not bits[spec.d_eff:].any()
        # the reference's sign_fn takes a riffled position p and maps it
        # back to its scrambled position: p(i) for i gives i's sign
        f, L = spec._factor(row), spec._L_row(row)
        G = L // f
        p = (at % G) * f + at // G
        sign = np.asarray(_row_hashes(ref_spec, row)[1](
            jnp.asarray(p.astype(np.uint32))))
        np.testing.assert_array_equal(sign, 1.0 - 2.0 * bits[at])


# -- the build report ---------------------------------------------------------


def test_ptxas_report_and_kernel_names(tmp_path):
    log = tmp_path / "lib.log"
    log.write_text(
        "nvcc ...\n"
        "ptxas info    : Compiling entry function '_Z22cs_sketch_tiles_"
        "kernelILi8EEvPKfjPKiS3_Pfj6CsRowsij' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z22cs_sketch_tiles_"
        "kernelILi8EEvPKfjPKiS3_Pfj6CsRowsij\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 16 bytes "
        "smem\n"
        "ptxas info    : Compiling entry function '_Z19cs_hash_bits_kernel"
        "PKjPjx6CsRowsii' for 'sm_90a'\n"
        "ptxas info    : Used 10 registers, used 0 barriers\n")
    rep = build.ptxas_report(log)
    assert rep == {
        "cs_sketch_tiles_kernel<8>": {"registers": 64,
                                      "smem_static_bytes": 16,
                                      "spill_stores_bytes": 8,
                                      "spill_loads_bytes": 4},
        "cs_hash_bits_kernel": {"registers": 10, "smem_static_bytes": 0,
                                "spill_stores_bytes": 0,
                                "spill_loads_bytes": 0}}


def test_sass_counts_and_the_per_coordinate_loop():
    """``cuobjdump -sass`` text: NOPs are not counted, and the innermost
    loop (a backward branch to a label) that holds a global store is a
    walk kernel's per-coordinate body."""
    text = (
        "\t\tFunction : _Z14k2_walk_kernelILi15EEvPKf\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
        ".L_x_1:\n"
        "        /*0010*/                   S2R R0, SR_TID.X ;\n"
        ".L_x_2:\n"
        "        /*0020*/                   IADD3 R0, R0, 1, RZ ;\n"
        "        /*0030*/                   STG.E desc[UR4][R2.64], R5 ;\n"
        "        /*0040*/              @P0 BRA `(.L_x_2) ;\n"
        "        /*0050*/                   NOP ;\n"
        "        /*0060*/              @P1 BRA `(.L_x_1) ;\n"
        "        /*0070*/                   EXIT ;\n"
        "\t\tFunction : _Z13k2_old_kernelPKf\n"
        "        /*0000*/                   STG.E desc[UR4][R2.64], R5 ;\n"
        "        /*0010*/                   EXIT ;\n"
        "\t\tFunction : _Z25cs_estimate_median_kernelILi5ELb1EEvPKf\n"
        "        /*0000*/                   S2R R0, SR_TID.X ;\n"
        "        /*0010*/                   STG.E desc[UR4][R2.64], R5 ;\n"
        "        /*0020*/                   IADD3 R0, R0, 1, RZ ;\n"
        "        /*0030*/              @P0 BRA 0x10 ;\n"
        "        /*0040*/                   BRA 0x40;\n")
    sass = build.parse_sass(text)
    assert {k: sum(isinstance(x, str) for x in v) for k, v in sass.items()} \
        == {"k2_walk_kernel<15>": 7, "k2_old_kernel": 2,
            "cs_estimate_median_kernel<5,true>": 5}
    assert build.store_loop_counts(sass) == {
        "k2_walk_kernel<15>": 3, "k2_old_kernel": None,
        "cs_estimate_median_kernel<5,true>": 3}


def test_library_key_covers_every_header_the_sources_include():
    """Every header a kernel source includes is hashed into the library's
    name, so editing a header rebuilds every library that includes it."""
    srcs = sorted(build.CSRC.glob("*.cu"))
    assert srcs
    included = set()
    for src in srcs:
        included |= set(re.findall(r'#include "([^"]+)"', src.read_text()))
    assert included <= set(build.HEADERS)
    for header in build.HEADERS:
        assert (build.CSRC / header).is_file()


def test_kernel_names_with_type_arguments():
    """The bf16 forms' instantiations keep their type arguments apart in
    the build report (``float``, ``__nv_bfloat16``, bools, ints)."""
    assert build._kernel_name(
        "_Z22cs_sketch_tiles_kernelILi16ELb1E13__nv_bfloat16EvPKfj") == \
        "cs_sketch_tiles_kernel<16,true,__nv_bfloat16>"
    assert build._kernel_name("_Z21cs_estimate_at_kernelILi5EfEvPKT0_j") \
        == "cs_estimate_at_kernel<5,float>"
    assert build._kernel_name(
        "_Z25cs_estimate_median_kernelILi5ELi0ELb0ELi2EEvPKT_") == \
        "cs_estimate_median_kernel<5,0,false,2>"
    assert build._kernel_name("_Z19cs_hash_bits_kernelPKj") == \
        "cs_hash_bits_kernel"

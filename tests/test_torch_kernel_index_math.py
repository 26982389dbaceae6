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
  the table windows that each CUDA block reads.

No card, no JAX: exact integer comparisons, and the plain versions as the
float reference.
"""

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

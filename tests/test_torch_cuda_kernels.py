"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are CUDA C++
built for sm_90a at first use) and is marked ``cuda``; without a card each
one skips with the reason. The file imports no JAX, so it runs on the GPU
machine, which has none. From the repository root there:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

(``--noconftest`` because tests/conftest.py sets up JAX's CPU mesh.)

Tolerances: hash bits, estimates and medians exact (one bucket per row, a
sign flip and a compare-exchange network: no float reduction); tables
``atol = 1e-5 * max|table|``, since the kernel sums each bucket in (chunk,
offset) order and the plain ``index_add_`` in position order. K1's tile
kernel and its gather kernel sum in the same order and must agree bit for
bit.

The bf16 forms: K1's are bit-equal to the f32 kernel on bf16-rounded input
(bf16 operand) and to the f32 kernel's table rounded to bf16 (bf16
table), and within one bf16 ulp of each entry of the plain version (the
f32 sums differ in order, which can put a sum on either side of a bf16
rounding boundary; floor 1e-6 * max for sums that cancel); K2's and
K4's are exact against their plain versions, as the f32 forms are.

K1's chunk design and K2's row design (``csrc/riffle.cu``, the geometries
whose vector or table outgrows the L2) sum and pick in the same order as
the tile kernel and the walk: bit-equal to them in every form, at every
geometry here, through ``launch_sketch_rows`` / ``launch_estimate_median``
(the design each geometry takes is ``index_math``'s choice).
"""

import json

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops import countsketch as cs
from commefficient_tpu_torch.ops.cuda import countsketch as kern
from commefficient_tpu_torch.ops.cuda import index_math

pytestmark = pytest.mark.cuda

GEOMETRIES = [
    # (d, c, r, band, m): ResNet-9's FetchSGD path, small odd shapes
    (6_573_130, 500_000, 5, 16, None),
    (20_011, 4_000, 3, 16, 512),
    (212, 512, 4, 16, None),
    (1_200_003, 48_000, 8, 8, None),
]
K1_EDGE_GEOMETRIES = [
    # K1's tile edges: r = 8 and band 8 with a table width that is not a
    # multiple of the tile (32 strides), one whose rows end mid-tile, and
    # m = 32768, where the gather kernel runs
    (300_007, 20_000, 8, 8, 1024),
    (77_777, 9_000, 6, 16, 2048),
    (3_000_000, 40_000, 5, 16, None),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CountSketch kernels are CUDA "
                    "C++ and have no CPU mode (the plain versions are held "
                    "against the JAX package by test_torch_countsketch.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _vec(n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(n, generator=g, device=dev)


def _table_tol(want):
    return 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_device_hashes_bit_equal_host(dev, family):
    spec = cs.CountSketch(d=6_573_130, c=500_000, r=5, hash_family=family)
    rng = np.random.default_rng(0)
    hi = 2**31 - 1 if family == "poly4" else 2**32
    x = np.concatenate([rng.integers(0, hi, size=100_000),
                        np.arange(hi - 300, hi), np.arange(300)])
    xt = torch.from_numpy(x.astype(np.int64))
    for row in range(spec.r):
        for which, purpose, key in (("slot", 0, spec._row_key(row)),
                                    ("sign", 1, spec._row_key(row)
                                     ^ 0x9E3779B9)):
            if family == "poly4":
                want = cs.poly4(xt, spec._poly4_coeffs(row, purpose))
            else:
                want = cs.mix32(xt, key)
            got = kern.hash_bits_cuda(spec, row, xt.to(dev), which)
            np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES + K1_EDGE_GEOMETRIES)
def test_sketch_rows_matches_plain_and_is_deterministic(dev, d, c, r, band, m,
                                                        family):
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, hash_family=family)
    v_s = cs._scramble(spec, _vec(d, 1, dev))
    n0 = kern.sketch_rows.launches
    got = kern.sketch_rows(spec, v_s)
    again = kern.sketch_rows(spec, v_s)
    assert kern.sketch_rows.launches == n0 + 2
    torch.cuda.synchronize()
    want = kern.sketch_rows_torch(spec, v_s)
    assert got.shape == want.shape == spec.table_shape
    torch.testing.assert_close(got, want, rtol=0, atol=_table_tol(want))
    assert torch.equal(got, again)  # no atomics: bit-identical replays


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES + K1_EDGE_GEOMETRIES)
def test_sketch_tile_kernel_equals_gather_kernel(dev, d, c, r, band, m,
                                                 family):
    """The tile kernel (the main path's) and the gather kernel sum every
    bucket in the same order: bit-equal tables wherever the tile kernel
    runs."""
    from commefficient_tpu_torch.ops.cuda.build import load_library

    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, hash_family=family)
    v_s = cs._scramble(spec, _vec(d, 5, dev))
    rows, ptr, off, tile = kern._kernel_geometry(spec, str(dev))[:4]
    if spec.chunk_m > 8192:
        assert tile == 0  # the gather kernel's geometry
    tables = []
    for w in (tile, 0):
        t = torch.empty(spec.table_shape, device=dev)
        kern._launch(load_library().cs_sketch_rows, v_s.data_ptr(),
                     spec.d_eff, ptr.data_ptr(), off.data_ptr(),
                     t.data_ptr(), spec.c_actual, rows, spec.r,
                     kern._FAMILY[family], w, 0, 0, kern._stream())
        tables.append(t)
    torch.cuda.synchronize()
    assert torch.equal(tables[0], tables[1])
    assert torch.equal(tables[0], kern.sketch_rows(spec, v_s))


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES)
def test_estimate_median_matches_plain_exactly(dev, d, c, r, band, m, family):
    """K2 writes every coordinate's estimate in original order ([d]),
    exactly the plain version's (the gather, the median, the
    unscramble)."""
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, hash_family=family)
    table = _vec(r * spec.c_actual, 2, dev).reshape(spec.table_shape)
    n0 = kern.estimate_median.launches
    got = kern.estimate_median(spec, table)
    assert kern.estimate_median.launches == n0 + 1
    torch.cuda.synchronize()
    assert got.shape == (d,)
    assert torch.equal(got, kern.estimate_median_torch(spec, table))


K2_EDGE_GEOMETRIES = [
    # (d, c, r, band, m, scramble_block): no scramble (in-place writes, a
    # ragged last tile), a scramble block of 8, m = 32768, where the slot
    # tables are read in place, and m = 1000 with a scramble block of 15,
    # where the divisions by m and b are not shifts
    (20_011, 4_000, 3, 16, 512, 0),
    (50_011, 8_000, 5, 16, None, 0),
    (77_777, 9_000, 6, 16, 2048, 8),
    (3_000_000, 40_000, 5, 16, None, None),
    (20_011, 4_000, 3, 16, 1000, None),  # m = 1000, sblock 15
]


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m,sb", K2_EDGE_GEOMETRIES + [
    g + (None,) for g in GEOMETRIES])
def test_estimate_median_equals_k4_range_form_at_every_coordinate(
        dev, d, c, r, band, m, sb, family):
    """K2 and K4's range form at (0, d) walk the same tiles and read the
    same signed buckets: bit-equal, and both equal the plain version."""
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, scramble_block=sb,
                          hash_family=family)
    table = _vec(r * spec.c_actual, 8, dev).reshape(spec.table_shape)
    got = kern.estimate_median(spec, table)
    rng = kern.estimate_at_range(spec, table, 0, d)
    torch.cuda.synchronize()
    assert torch.equal(got, rng)
    assert torch.equal(got, kern.estimate_median_torch(spec, table))


ESTIMATE_AT_GEOMETRIES = [
    # (d, c, r, seed, n): tests/test_decode_blockwise.py's three — a table
    # over the reference's 12 MiB single-block guard, its forced many-block
    # geometry, and a single-block one
    (1_200_003, 1_100_000, 3, 11, 4096),
    (50_011, 8_000, 5, 7, 1025),
    (10_000, 2_000, 5, 7, 513),
]


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,seed,n", ESTIMATE_AT_GEOMETRIES)
def test_estimate_at_matches_plain_exactly(dev, d, c, r, seed, n, family):
    spec = cs.CountSketch(d=d, c=c, r=r, seed=seed, hash_family=family)
    table = _vec(r * spec.c_actual, seed, dev).reshape(spec.table_shape)
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randperm(d, generator=g, device=dev)[:n]
    idx[:5] = 0  # repeated pads, as in a gathered candidate buffer
    n0 = kern.estimate_at.launches
    got = kern.estimate_at(spec, table, idx)
    assert kern.estimate_at.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, kern.estimate_at_torch(spec, table, idx))


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_estimate_at_every_coordinate_is_k2_unscrambled(dev, family):
    spec = cs.CountSketch(d=6_573_130, c=500_000, r=5, hash_family=family)
    table = _vec(5 * spec.c_actual, 6, dev).reshape(spec.table_shape)
    got = kern.estimate_at(spec, table, torch.arange(spec.d, device=dev))
    want = kern.estimate_median(spec, table)  # in original order
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,seed,n", ESTIMATE_AT_GEOMETRIES + [
    (6_573_130, 500_000, 5, 42, None)])
def test_estimate_at_range_matches_plain_and_k2(dev, d, c, r, seed, n,
                                                family):
    """K4's range form, exactly, against its plain version and against K2
    (every coordinate, in original order), at n = 0, n = 1, a ragged n starting inside a scramble
    block, every coordinate, and the last rank's slice of a four-way
    split (clipped at d - 1)."""
    spec = cs.CountSketch(d=d, c=c, r=r, seed=seed, hash_family=family)
    table = _vec(r * spec.c_actual, seed, dev).reshape(spec.table_shape)
    full = kern.estimate_median(spec, table)
    S = -(-d // 4)
    for start, cnt in ((5, 0), (d - 1, 1), (spec.sblock // 2 + 1, 3001),
                       (0, d), (3 * S, S)):
        n0 = kern.estimate_at_range.launches
        got = kern.estimate_at_range(spec, table, start, cnt)
        assert kern.estimate_at_range.launches == n0 + (cnt > 0)
        torch.cuda.synchronize()
        assert got.shape == (cnt,)
        assert torch.equal(got, kern.estimate_at_range_torch(spec, table,
                                                             start, cnt))
        idx = torch.clamp(start + torch.arange(cnt, device=dev), max=d - 1)
        assert torch.equal(got, full[idx])


def test_sketch_sparse_replays_bit_for_bit(dev):
    """The error feedback's sparse sketch on the card: a candidate buffer
    of distinct coordinates plus (i, 0.0) pads, one of them on a real
    candidate, sketches to the same table every time (K1 sums the
    buckets in a fixed order; the [d] scatter adds only 0.0 in collision)
    and agrees with the plain CPU path up to summation order."""
    spec = cs.CountSketch(d=6_573_130, c=500_000, r=5)
    g = torch.Generator(device=dev).manual_seed(9)
    idx = torch.randperm(spec.d, generator=g, device=dev)[:50_000]
    vals = torch.randn(50_000, generator=g, device=dev)
    idx[-20_000:], vals[-20_000:] = idx[0], 0.0  # pads on a real candidate
    n0 = kern.sketch_rows.launches
    a = cs.sketch_sparse(spec, idx, vals)
    b = cs.sketch_sparse(spec, idx, vals)
    assert kern.sketch_rows.launches == n0 + 2
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = cs.sketch_sparse(spec, idx.cpu(), vals.cpu())
    torch.testing.assert_close(a.cpu(), want, rtol=0, atol=_table_tol(want))


@pytest.mark.parametrize("r", range(1, 9))
def test_median_rows_matches_plain_exactly(dev, r):
    x = _vec(r * 100_003, r, dev).reshape(r, 100_003)
    x[0, :7] = float("nan")  # a diverged row propagates like torch.minimum
    got = kern.median_rows(x)
    torch.cuda.synchronize()
    want = kern.median_rows_torch(x)
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(got[ok], want[ok])
    if r % 2:
        assert torch.equal(got[ok], torch.median(x, 0).values[ok])


def test_sketch_estimate_round_trip_recovers_heavy_hitters(dev):
    spec = cs.CountSketch(d=6_573_130, c=500_000, r=5)
    v = _vec(spec.d, 3, dev) * 1e-3
    g = torch.Generator(device=dev).manual_seed(4)
    hh = torch.randperm(spec.d, generator=g, device=dev)[:100]
    v[hh] += 10.0
    update = cs.unsketch(spec, cs.sketch_vec(spec, v), 100)
    assert set(hh.tolist()) == set(torch.nonzero(update)[:, 0].tolist())
    torch.testing.assert_close(update[hh], v[hh], rtol=0, atol=0.05)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    spec = cs.CountSketch(d=10_000, c=2_000, r=5)
    with pytest.raises(ValueError, match="shape"):
        kern.sketch_rows(spec, torch.zeros(spec.d_eff + 1, device=dev))
    with pytest.raises(TypeError, match="float32"):
        kern.estimate_median(spec, torch.zeros(spec.table_shape,
                                               dtype=torch.float64,
                                               device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        kern.median_rows(torch.zeros(10, 3, device=dev).t())
    with pytest.raises(ValueError, match="rows"):
        kern.median_rows(torch.zeros(9, 3, device=dev))
    table = torch.zeros(spec.table_shape, device=dev)
    with pytest.raises(TypeError, match="int64"):
        kern.estimate_at(spec, table, torch.zeros(3, dtype=torch.int32,
                                                  device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        kern.estimate_at(spec, table, torch.zeros(3, 2, dtype=torch.int64,
                                                  device=dev)[:, 0])
    with pytest.raises(ValueError, match=">= 0"):
        kern.estimate_at_range(spec, table, -1, 3)
    with pytest.raises(TypeError, match="float32"):
        kern.estimate_at_range(spec, table.double(), 0, 3)


# -- the bf16 forms ------------------------------------------------------------

BF16_GEOMETRIES = [GEOMETRIES[0], GEOMETRIES[1], GEOMETRIES[3],
                   K1_EDGE_GEOMETRIES[0]]
BF = torch.bfloat16
K1_FORMS = {"bf16_operand": (BF, torch.float32),
            "bf16_table": (torch.float32, BF),
            "bf16_operand_bf16_table": (BF, BF)}


def _assert_k1_form(spec, v_s, form):
    """K1 in ``form`` against the f32 kernel (bit-equal) and the plain
    version (one bf16 ulp of each entry, or the f32 table bound)."""
    operand, table_dtype = K1_FORMS[form]
    n0 = kern.sketch_rows.forms.get(form, 0)
    got = kern.sketch_rows(spec, v_s, operand, table_dtype)
    assert kern.sketch_rows.forms[form] == n0 + 1
    assert got.dtype == table_dtype and got.shape == spec.table_shape
    x = v_s.to(BF).float() if operand == BF else v_s
    assert torch.equal(got, kern.sketch_rows(spec, x).to(table_dtype))
    assert torch.equal(got, kern.sketch_rows(spec, v_s, operand,
                                             table_dtype))
    want = kern.sketch_rows_torch(spec, v_s, operand, table_dtype).float()
    g = got.float()
    if table_dtype == BF:
        bound = 2.0**-7 * want.abs() + 1e-6 * float(want.abs().max())
        assert bool(((g - want).abs() <= bound).all())
    else:
        torch.testing.assert_close(g, want, rtol=0, atol=_table_tol(want))


@pytest.mark.parametrize("form", sorted(K1_FORMS))
@pytest.mark.parametrize("d,c,r,band,m", BF16_GEOMETRIES)
def test_sketch_rows_bf16_forms(dev, d, c, r, band, m, form):
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m)
    _assert_k1_form(spec, cs._scramble(spec, _vec(d, 2, dev)), form)


K2_FORMS = {"f32_table_bf16_operand": (torch.float32, BF),
            "bf16_table": (BF, torch.float32)}


def _assert_k2_form(spec, table, form):
    table_dtype, operand = K2_FORMS[form]
    t = table.to(table_dtype)
    n0 = kern.estimate_median.forms.get(form, 0)
    got = kern.estimate_median(spec, t, operand)
    assert kern.estimate_median.forms[form] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (spec.d,)
    assert torch.equal(got, kern.estimate_median_torch(spec, t, operand))
    # the same as the f32 form on the table rounded to bf16
    assert torch.equal(got, kern.estimate_median(spec, table.to(BF).float()))


@pytest.mark.parametrize("form", sorted(K2_FORMS))
@pytest.mark.parametrize("d,c,r,band,m", BF16_GEOMETRIES)
def test_estimate_median_bf16_forms_match_plain_exactly(dev, d, c, r, band,
                                                        m, form):
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m)
    gen = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn(spec.table_shape, generator=gen, device=dev)
    _assert_k2_form(spec, table, form)


@pytest.mark.parametrize("d,c,r,band,m", BF16_GEOMETRIES)
def test_estimate_at_bf16_table_matches_plain_exactly(dev, d, c, r, band, m):
    """K4, both forms, on a bf16 table: widened at the read, never rounded
    further, so equal to the f32 kernel on the widened table."""
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m)
    gen = torch.Generator(device=dev).manual_seed(4)
    table = torch.randn(spec.table_shape, generator=gen, device=dev).to(BF)
    idx = torch.randperm(d, generator=gen, device=dev)[:5000]
    got = kern.estimate_at(spec, table, idx)
    assert torch.equal(got, kern.estimate_at_torch(spec, table, idx))
    assert torch.equal(got, kern.estimate_at(spec, table.float(), idx))
    S = -(-d // 4)
    for start, n in ((0, d), (3 * S, S)):
        n0 = kern.estimate_at_range.forms.get("bf16_table", 0)
        rng = kern.estimate_at_range(spec, table, start, n)
        assert kern.estimate_at_range.forms["bf16_table"] == n0 + 1
        assert torch.equal(rng, kern.estimate_at_range_torch(spec, table,
                                                             start, n))
        assert torch.equal(rng, kern.estimate_at_range(spec, table.float(),
                                                       start, n))


def test_gpt2_geometry_k1_and_k2_all_forms(dev):
    """The GPT-2 path's geometry (D = 124,444,417, r = 5, c = 5,000,000:
    m = 8192, V = 5248): K1 in its chunk design (32 strides a tile) in
    every form, and K2 in its row design with row 0 in the final walk, in
    every form, each against its plain version."""
    spec = cs.CountSketch(d=124_444_417, c=5_000_000, r=5)
    plan = kern._k2_plan(spec, str(dev))
    # the walk's plan stages no window and reads the slot tables in place
    assert spec.chunk_m == 8192 and plan["staged"] == ()
    assert plan["slot_smem"] is False
    assert kern._k2_plan(spec, str(dev), 2)["staged"] == ()  # bf16 windows
    assert (plan["design"], plan["nt"]) == ("rows", 1)
    assert kern._kernel_geometry(spec, str(dev))[4] == ("chunks", 32)
    try:
        v_s = cs._scramble(spec, _vec(spec.d, 6, dev))
        t = kern.sketch_rows(spec, v_s)
        want = kern.sketch_rows_torch(spec, v_s)
        torch.testing.assert_close(t, want, rtol=0, atol=_table_tol(want))
        del want
        for form in K1_FORMS:
            _assert_k1_form(spec, v_s, form)
        del v_s
        assert torch.equal(kern.estimate_median(spec, t),
                           kern.estimate_median_torch(spec, t))
        for form in K2_FORMS:
            _assert_k2_form(spec, t, form)
    finally:
        kern._plain_maps.cache_clear()  # ~7.5 GB of columns and signs


G2_FORMS = sorted({("k1", f) for f in ("f32", *K1_FORMS)}
                  | {("k2", f) for f in ("f32", *K2_FORMS)})


@pytest.mark.parametrize("kernel,form", G2_FORMS)
def test_gpt2_geometry_new_designs_bit_equal_old_kernels(dev, kernel, form):
    """At GPT-2's geometry each form of K1's chunk design is bit-equal to
    the tile kernel and each form of K2's row design,
    with row 0 in the final walk and through the pass, to the walk and to
    the plain version."""
    spec = cs.CountSketch(d=124_444_417, c=5_000_000, r=5)
    if kernel == "k1":
        operand, table_dtype = K1_FORMS.get(form, (torch.float32,
                                                   torch.float32))
        v_s = cs._scramble(spec, _vec(spec.d, 9, dev))
        tile = kern._kernel_geometry(spec, str(dev))[3]
        got = kern.launch_sketch_rows(spec, v_s, operand, table_dtype,
                                      "chunks", 32)
        old = kern.launch_sketch_rows(spec, v_s, operand, table_dtype,
                                      "tiles", tile)
        torch.cuda.synchronize()
        assert torch.equal(got, old)
        return
    table_dtype, operand = K2_FORMS.get(form, (torch.float32, torch.float32))
    t = _vec(spec.r * spec.c_actual, 10, dev).reshape(
        spec.table_shape).to(table_dtype)
    walk = kern.launch_estimate_median(spec, t, operand, "walk")
    try:
        assert torch.equal(walk, kern.estimate_median_torch(spec, t,
                                                            operand))
    finally:
        kern._plain_maps.cache_clear()
    for nt in (1, 0):
        got = kern.launch_estimate_median(spec, t, operand, "rows", nt)
        torch.cuda.synchronize()
        assert torch.equal(got, walk), nt


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES + K1_EDGE_GEOMETRIES)
def test_sketch_chunk_design_equals_tile_kernel(dev, d, c, r, band, m,
                                                family):
    """K1's chunk design, wherever its block fits (not at m = 32768), in
    every form and at two tile widths, bit-equal to the tile kernel."""
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, hash_family=family)
    shapes = [(spec.chunk_m, spec.s_row(k), spec.V_row(k))
              for k in range(r)]
    width = index_math.chunk_tile_strides(shapes)
    if spec.chunk_m > 8192:
        assert width == 0  # two 32768-float chunk buffers do not fit
        return
    tile = kern._kernel_geometry(spec, str(dev))[3]
    v_s = cs._scramble(spec, _vec(d, 11, dev))
    for operand, table_dtype in [(torch.float32, torch.float32),
                                 *K1_FORMS.values()]:
        old = kern.launch_sketch_rows(spec, v_s, operand, table_dtype,
                                      "tiles", tile)
        for w in sorted({width, 1}):
            got = kern.launch_sketch_rows(spec, v_s, operand, table_dtype,
                                          "chunks", w)
            torch.cuda.synchronize()
            assert torch.equal(got, old), (operand, table_dtype, w)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m,sb", K2_EDGE_GEOMETRIES + [
    g + (None,) for g in GEOMETRIES])
def test_estimate_rows_design_equals_walk_and_plain(dev, d, c, r, band, m, sb,
                                                    family):
    """K2's row design, row 0 in the final walk (where the slot tables fit
    uint16) and through the pass, in every table kind, bit-equal to the
    walk and to the plain version: no scramble, scramble blocks of 8 and
    15, m = 1000 and m = 32768."""
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, scramble_block=sb,
                          hash_family=family)
    table = _vec(r * spec.c_actual, 12, dev).reshape(spec.table_shape)
    plan = kern._k2_plan(spec, str(dev))
    nts = (0, 1) if plan["rows_slot_smem"] else (0,)
    for table_dtype, operand in [(torch.float32, torch.float32),
                                 *K2_FORMS.values()]:
        t = table.to(table_dtype)
        want = kern.estimate_median_torch(spec, t, operand)
        assert torch.equal(kern.launch_estimate_median(spec, t, operand,
                                                       "walk"), want)
        for nt in nts:
            got = kern.launch_estimate_median(spec, t, operand, "rows", nt)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (table_dtype, operand, nt)


def test_new_designs_refuse_what_they_do_not_take(dev):
    """No fallback: K1's chunk design refuses a v_s that is not 16-byte
    aligned, and a launch that the C entry refuses (a riffled scratch
    narrower than a row; K2's row design at r = 1) raises."""
    from commefficient_tpu_torch.ops.cuda.build import load_library

    spec = cs.CountSketch(d=50_011, c=8_000, r=5)
    buf = torch.zeros(spec.d_eff + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kern.launch_sketch_rows(spec, buf[1:], torch.float32, torch.float32,
                                "chunks", 8)
    rows, ptr, off = kern._kernel_geometry(spec, str(dev))[:3]
    table = torch.empty(spec.table_shape, device=dev)
    signs0 = kern.packed_sign_bits(spec, dev, rows=(0,))
    with pytest.raises(RuntimeError, match="cs_sketch_chunks"):
        kern._launch(load_library().cs_sketch_chunks, buf.data_ptr(),
                     spec.d_eff, ptr.data_ptr(), off.data_ptr(),
                     table.data_ptr(), spec.c_actual, rows, spec.r, 0, 8, 0,
                     0, buf.data_ptr(), 4, signs0.data_ptr(),
                     kern._stream())
    one = cs.CountSketch(d=50_011, c=8_000, r=1)
    with pytest.raises(RuntimeError, match="cs_estimate_rows"):
        kern.launch_estimate_median(one, torch.zeros(one.table_shape,
                                                     device=dev),
                                    torch.float32, "rows", 0)


def test_fixup_resnet50_geometry_k1_and_k2(dev):
    """FixupResNet-50's FetchSGD geometry (D = 25,504,026, r = 5, c at the
    envelope's suggestion 1,071,171: realized 1,080,848, m = 8192): K1's
    chunk design (its 102 MB vector outgrows the L2), and K2 in its row
    design (the walk's five slot tables do not fit shared memory at m =
    8192), each against its plain version, and K2 against K4's range
    form at every coordinate."""
    spec = cs.CountSketch(d=25_504_026, c=1_071_171, r=5)
    assert (spec.c_actual, spec.chunk_m) == (1_080_848, 8192)
    plan = kern._k2_plan(spec, str(dev))
    assert plan["staged"] == (0, 1) and plan["slot_smem"] is False
    assert (plan["design"], plan["nt"]) == ("rows", 1)
    assert kern._kernel_geometry(spec, str(dev))[4] == ("chunks", 32)
    try:
        v_s = cs._scramble(spec, _vec(spec.d, 8, dev))
        t = kern.sketch_rows(spec, v_s)
        want = kern.sketch_rows_torch(spec, v_s)
        torch.testing.assert_close(t, want, rtol=0, atol=_table_tol(want))
        assert torch.equal(t, kern.sketch_rows(spec, v_s))
        del want, v_s
        est = kern.estimate_median(spec, t)
        assert torch.equal(est, kern.estimate_median_torch(spec, t))
        assert torch.equal(est, kern.estimate_at_range(spec, t, 0, spec.d))
    finally:
        kern._plain_maps.cache_clear()


def test_bf16_forms_refuse_the_gather_kernel(dev):
    """K1's gather kernel (m = 32768, no tile kernel) is f32 only."""
    spec = cs.CountSketch(*K1_EDGE_GEOMETRIES[2][:3], band=16)
    assert kern._kernel_geometry(spec, str(dev))[3] == 0
    v_s = torch.zeros(spec.d_eff, device=dev)
    for operand, table_dtype in K1_FORMS.values():
        with pytest.raises(ValueError, match="gather kernel"):
            kern.sketch_rows(spec, v_s, operand, table_dtype)


# -- K1's segment form ------------------------------------------------------------

SEGMENT_GEOMETRIES = [
    # (d, c, r, band, m): ResNet-9's and GPT-2's FetchSGD geometries (the
    # fused backward's), and small ones with r of 1, 3 and 5
    (6_573_130, 500_000, 5, 16, None),
    (124_444_417, 5_000_000, 5, 16, None),
    (20_011, 4_000, 3, 16, 512),
    (3_001, 600, 1, 16, None),
]


def _segments(d, sb):
    """Leaves of 1, 63, 64 and 65 values, offsets that straddle a scramble
    block, the last leaf ending at d, and one leaf of a quarter of d."""
    mid = (d // 2) // sb * sb
    return [(0, 1), (sb - 1, 63), (mid, 64), (mid + sb // 2, 65),
            (d - 65, 65), (d // 4, d // 4)]


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m", SEGMENT_GEOMETRIES)
def test_sketch_segment_matches_plain_and_is_deterministic(dev, d, c, r, band,
                                                           m, family):
    """Each segment added into a table that already holds values: the
    plain version's table to ``1e-5 * max|table|`` (the order of the sums
    differs), two launches bit-identical, and the segments' tables summed
    equal to K1 of the whole vector to the same tolerance."""
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, hash_family=family)
    base = kern.sketch_rows(spec, cs._scramble(spec, _vec(d, 5, dev)))
    for offset, n in _segments(d, spec.sblock):
        vals = _vec(n, offset + 1, dev)
        got = kern.sketch_segment(spec, offset, vals, base.clone())
        again = kern.sketch_segment(spec, offset, vals, base.clone())
        want = kern.sketch_segment_torch(spec, offset, vals, base.clone())
        assert torch.equal(got, again), (offset, n)
        assert float((got - want).abs().max()) <= _table_tol(want), (offset,
                                                                     n)
    v = _vec(d, 9, dev)
    cuts = [0, 1, 64, 129, d // 3, d]
    table = torch.zeros(spec.table_shape, device=dev)
    for a, b in zip(cuts, cuts[1:]):
        kern.sketch_segment(spec, a, v[a:b].contiguous(), table)
    whole = kern.sketch_rows(spec, cs._scramble(spec, v))
    assert float((table - whole).abs().max()) <= _table_tol(whole)
    kern._plain_maps.cache_clear()
    torch.cuda.empty_cache()


SEGMENT_EDGES = {
    # name: (d, c, r, offset, n) at the FetchSGD band 16 and default m
    "small_path_limit": (6_573_130, 500_000, 5, 1_000, 8_192),
    "one_past_the_limit": (6_573_130, 500_000, 5, 1_000, 8_193),
    "row_groups": (6_573_130, 500_000, 5, 77, 4_400_000),
    "value_windows": (124_444_417, 5_000_000, 5, 5, 2 * 1_300 * 8_192 + 5),
    "ends_at_d": (6_573_130, 500_000, 5, 6_273_130, 300_000),
    "buckets_over_a_sub_batch": (200_003, 3_000, 3, 3, 150_000),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_EDGES))
def test_sketch_segment_edges(dev, case):
    """The segment form's boundaries: the small path at its limit (8192
    values) and the two passes one past it, a leaf whose rows go in groups
    of two, a leaf over three windows of one row each, a large leaf that
    ends at d, and (row, tile) buckets of more pairs than the owner's
    sub-batch: each the plain version's table to ``1e-5 * max|table|``,
    two launches bit-identical."""
    from commefficient_tpu_torch.ops.cuda import index_math

    d, c, r, offset, n = SEGMENT_EDGES[case]
    spec = cs.CountSketch(d=d, c=c, r=r)
    scratch = kern._segment_scratch(spec, str(dev))
    windows = index_math.segment_windows(r, n, scratch["capacity"])
    spos = spec.scrambled_pos(offset + torch.arange(n, device=dev))
    cols = spec.scrambled_cols_signs(0, spos)[0]
    shift = scratch["shifts"][windows[0][1] - 1]
    biggest = int(torch.bincount(cols >> shift).max())
    del spos, cols
    reach = {"small_path_limit": index_math.segment_small(n),
             "one_past_the_limit": not index_math.segment_small(n),
             "row_groups": [w[1] for w in windows] == [2, 2, 1],
             "value_windows": len(windows) == 3 * r and windows[1][2] > 0,
             "ends_at_d": offset + n == d and not index_math.segment_small(n),
             "buckets_over_a_sub_batch": biggest > 3 * index_math.SEG_BATCH}
    assert reach[case], windows
    base = _vec(r * spec.c_actual, 4, dev).view(spec.table_shape)
    vals = _vec(n, 8, dev)
    got = kern.sketch_segment(spec, offset, vals, base.clone())
    again = kern.sketch_segment(spec, offset, vals, base.clone())
    want = kern.sketch_segment_torch(spec, offset, vals, base.clone())
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= _table_tol(want)
    del got, again, want
    torch.cuda.empty_cache()


def test_sketch_segment_refuses_what_it_does_not_take(dev):
    spec = cs.CountSketch(d=20_011, c=4_000, r=3, m=512)
    table = torch.zeros(spec.table_shape, device=dev)
    with pytest.raises(ValueError, match="inside"):
        kern.sketch_segment(spec, 20_000, torch.ones(12, device=dev), table)
    with pytest.raises(TypeError):
        kern.sketch_segment(spec, 0, torch.ones(4, device=dev,
                                                dtype=torch.bfloat16), table)
    with pytest.raises(TypeError):
        kern.sketch_segment(spec, 0, torch.ones(4, device=dev),
                            table.to(torch.bfloat16))
    with pytest.raises(ValueError, match="vals on"):
        kern.sketch_segment(spec, 0, torch.ones(4), table)
    misaligned = torch.zeros(table.numel() + 1, device=dev)[1:].view(
        spec.table_shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kern.sketch_segment(spec, 0, torch.ones(4, device=dev), misaligned)


def test_staged_round_equals_unstaged_with_the_ring_reused(dev):
    """The pipelined engine's early copies (``FederatedSession.
    stage_round_payload``: pinned ring, a side stream, an event the round
    waits on) train exactly what unstaged rounds train: a sketch session of
    a linear model, 6 rounds staged by the engine's worker thread at depth
    1 (a ring of 2 buffers, reused past its depth) against 6 rounds copied
    at dispatch, every leaf bit-equal. Staging from this thread reuses the
    same two pinned buffers round after round."""
    import numpy as np

    from commefficient_tpu_torch.data import FedDataset, FedSampler
    from commefficient_tpu_torch.models.losses import softmax_cross_entropy
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.pipeline import PipelinedRounds
    from commefficient_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(512, 48)).astype(np.float32),
            "y": rng.integers(0, 10, 512).astype(np.int32)}
    ds = FedDataset(data, 16, iid=True, seed=0)

    def loss_fn(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        y = batch["y"]
        return softmax_cross_entropy(logits, y), {
            "count": torch.tensor(float(y.numel()), device=y.device)}

    params = {"w": (0.01 * rng.normal(size=(48, 10))).astype(np.float32),
              "b": np.zeros(10, np.float32)}
    cfg = Config(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                 k=64, num_rows=3, num_cols=256, num_clients=16,
                 num_workers=4, local_batch_size=8, num_devices=1,
                 device="cuda", device_data=False, pipeline_depth=1)

    def run(staged):
        sess = FederatedSession(cfg, params, loss_fn)
        sampler = FedSampler(ds, num_workers=4, local_batch_size=8, seed=1)
        if staged:
            eng = PipelinedRounds(cfg, sess, sampler, lambda s: 0.1, 6,
                                  steps_per_epoch=16).start(0)
            try:
                losses = [m["loss"] for _, _, m, _, _ in
                          eng.epoch_rounds(0, 0, 6)]
            finally:
                eng.close()
        else:
            losses = []
            for s in range(6):
                ids, batch = sampler.sample_round(s)
                losses.append(sess.train_round(ids, batch, 0.1)["loss"])
        return sess, [float(x) for x in losses]

    plain, l_plain = run(False)
    piped, l_piped = run(True)
    assert l_piped == l_plain
    for leaf in ("params_vec", "momentum", "error"):
        assert torch.equal(getattr(piped.state, leaf),
                           getattr(plain.state, leaf)), leaf

    sess = FederatedSession(cfg, params, loss_fn)
    sampler = FedSampler(ds, num_workers=4, local_batch_size=8, seed=1)
    ptrs = set()
    for s in range(5):
        ids, batch = sampler.sample_round(s, alloc=sess.staging_alloc)
        ids_d, dev_batch, ready = sess.stage_round_payload(ids, batch)
        assert ready is not None and dev_batch["x"].is_cuda
        sess.train_round(ids_d, dev_batch, 0.1, ready=ready)
        ptrs.add(sess._stager()._rings["x"][s % 2][0].data_ptr())
    assert len(ptrs) == 2  # two pinned buffers served five rounds
    torch.cuda.synchronize()


@pytest.mark.parametrize("num_blocks", [4, 7])
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES[:2])
def test_estimate_all_num_blocks_is_k4_range_slices_equal_k2(
        dev, d, c, r, band, m, num_blocks):
    """``estimate_all`` at ``num_blocks > 1``: K4's range form over the
    slices, the last padded by repeating d - 1 (its clip), exactly its
    plain version slice by slice and exactly K2 (num_blocks 1)."""
    geo = dict(d=d, c=c, r=r, band=band, m=m)
    spec = cs.CountSketch(num_blocks=num_blocks, **geo)
    g = torch.Generator(device=dev).manual_seed(num_blocks)
    table = torch.randn(spec.table_shape, generator=g, device=dev)
    kern.reset_launch_counts()
    got = cs.estimate_all(spec, table)
    blk = -(-d // num_blocks)
    starts = range(0, d, blk)
    assert kern.launch_counts()["estimate_at_range"] == len(starts)
    assert kern.launch_counts()["estimate_median"] == 0
    tail = kern.estimate_at_range(spec, table, starts[-1], blk)
    plain = torch.cat([kern.estimate_at_range_torch(spec, table, s, blk)
                       for s in starts])
    assert torch.equal(tail, plain[starts[-1]:starts[-1] + blk])
    assert torch.equal(got, plain[:d])
    assert torch.equal(got, cs.estimate_all(cs.CountSketch(**geo), table))


@pytest.mark.parametrize("buffers,kb", [(2, 50_000), (8, 6_250), (1, 17)])
def test_rank_by_rank_pair_scatter_bit_equal_plain(dev, buffers, kb):
    """``scatter_add_pairs`` of gathered rank buffers (local_topk's W*k
    pairs: coordinates that collide across ranks, (0, 0.0) pads inside a
    buffer) on the card, bit-equal to its plain version on the CPU (which
    adds in order, as the reference's scatter does)."""
    from commefficient_tpu_torch.ops.collectives import (
        compact_pairs,
        scatter_add_pairs,
    )

    d = 6_573_130
    g = torch.Generator().manual_seed(buffers)
    idx, val = [], []
    for _ in range(buffers):
        v = torch.zeros(d)
        hot = torch.randint(0, d // 50, (kb - 3,), generator=g)  # collide
        v[hot] = torch.randn(hot.numel(), generator=g)
        i, x = compact_pairs(v, kb)
        idx.append(i)
        val.append(x)
    idx, val = torch.cat(idx), torch.cat(val)
    want = scatter_add_pairs(d, idx, val, buffers=buffers)
    got = scatter_add_pairs(d, idx.to(dev), val.to(dev), buffers=buffers)
    assert torch.equal(got.cpu(), want)
    assert int((want != 0).sum()) > 0


def test_prewarmed_ten_rung_ladder_switches_build_no_plan(dev):
    """A 10-rung ``num_cols`` ladder (a linear model's sketch session):
    the controller's prewarm builds every rung's K1, K2 and K4 plans and
    runs the migration's torch ops on scratch tensors, launching no
    CountSketch kernel; then a switch to every rung (each table decoded by
    K2 and re-sketched by K1) builds no plan."""
    import warnings

    import numpy as np

    from commefficient_tpu_torch.control import build_controller
    from commefficient_tpu_torch.data import FedDataset, FedSampler
    from commefficient_tpu_torch.models.losses import softmax_cross_entropy
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(256, 48)).astype(np.float32),
            "y": rng.integers(0, 10, 256).astype(np.int32)}

    def loss_fn(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        y = batch["y"]
        return softmax_cross_entropy(logits, y), {
            "count": torch.tensor(float(y.numel()), device=y.device)}

    params = {"w": (0.01 * rng.normal(size=(48, 10))).astype(np.float32),
              "b": np.zeros(10, np.float32)}
    cols = ",".join(str(c) for c in range(256, 16, -24))
    cfg = Config(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                 k=64, num_rows=3, num_cols=256, num_clients=16,
                 num_workers=4, local_batch_size=8, num_devices=1,
                 device="cuda", device_data=False, control_policy="fixed",
                 control_schedule="0-=0", ladder=f"num_cols={cols}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, params, loss_fn)
    ctrl = build_controller(cfg, sess, num_rounds=8)
    kern.reset_launch_counts()
    assert ctrl.prewarm() == 10
    assert sum(kern.launch_counts().values()) == 0
    sampler = FedSampler(FedDataset(data, 16, iid=True, seed=0),
                         num_workers=4, local_batch_size=8, seed=1)
    for s in range(2):
        ids, batch = sampler.sample_round(s)
        sess.train_round(ids, batch, 0.1)
    built = kern.plan_builds()
    kern.reset_launch_counts()
    for i in [*range(1, 10), 0]:
        sess.set_active_rung(i)
        assert sess.state.error.shape == sess.rungs[i].spec.table_shape
    torch.cuda.synchronize()
    assert kern.plan_builds() == built
    n = kern.launch_counts()
    assert n["estimate_median"] == n["sketch_rows"] == 2 * 10


def test_captured_scan_block_equals_eager_rounds_and_counts_launches(
        dev, tmp_path):
    """The scan engine's CUDA graph (``pipeline/scan_engine.py``): a sketch
    session of a linear model on the device-resident index path with the
    exact top-k at ``--scan_rounds 3``, 7 rounds (blocks 3, 3, 1: two
    programs captured, three replays), every leaf and loss bit-equal to
    the same 7 rounds dispatched one by one. Launches: the kernel events
    of a ``torch.profiler`` trace that correlate with the three graph
    launches equal the per-round path's counts (K1 twice and K2 once a
    round); the wrappers counted only the warm-up round's eager launches
    and recorded the captures' kernels apart; no re-capture."""
    from commefficient_tpu_torch.data import FedDataset, FedSampler
    from commefficient_tpu_torch.models.losses import softmax_cross_entropy
    from commefficient_tpu_torch.parallel import FederatedSession
    from commefficient_tpu_torch.pipeline import ScanRounds
    from commefficient_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(512, 48)).astype(np.float32),
            "y": rng.integers(0, 10, 512).astype(np.int32)}
    ds = FedDataset(data, 16, iid=True, seed=0)

    def loss_fn(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        y = batch["y"]
        return softmax_cross_entropy(logits, y), {
            "count": torch.sum(y >= 0).to(torch.float32)}

    params = {"w": (0.01 * rng.normal(size=(48, 10))).astype(np.float32),
              "b": np.zeros(10, np.float32)}
    cfg = Config(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                 k=64, num_rows=3, num_cols=256, num_clients=16,
                 num_workers=4, local_batch_size=8, num_devices=1,
                 device="cuda", scan_rounds=3, max_retraces=0)

    def lr_fn(s):
        return 0.1 - 0.005 * s

    def session():
        sess = FederatedSession(cfg, params, loss_fn)
        sampler = FedSampler(ds, num_workers=4, local_batch_size=8, seed=1)
        assert sess.maybe_attach_data(ds, sampler)
        return sess, sampler

    eager, sampler = session()
    kern.reset_launch_counts()
    l_eager = [float(eager.train_round_indices(
        *sampler.sample_round_indices(r), lr_fn(r))["loss"])
        for r in range(7)]
    want = kern.launch_counts()
    sess, sampler = session()
    eng = ScanRounds(cfg, sess, sampler, lr_fn, 7, steps_per_epoch=7)
    kern.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        l_scan = [float(m["loss"]) for _, _, m, _, _ in eng.epoch_rounds(
            0, 0, 7)]
        torch.cuda.synchronize()
    got = kern.launch_counts()
    captured = {k: sum(v.values()) for k, v in kern.capture_counts().items()}
    st = eng.stats()
    prof.export_chrome_trace(str(tmp_path / "scan.json"))
    events = json.loads((tmp_path / "scan.json").read_text())["traceEvents"]
    graph = {e["args"]["correlation"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e.get("name", "").startswith(("cudaGraphLaunch",
                                                "cuGraphLaunch"))}
    replayed = {w: sum(1 for e in events if e.get("cat") == "kernel"
                       and e["args"].get("correlation") in graph
                       and sym in e.get("name", ""))
                for w, sym in (("sketch_rows", "cs_sketch_"),
                               ("estimate_median", "cs_estimate_median"))}
    assert l_scan == l_eager
    for leaf in ("params_vec", "momentum", "error"):
        assert torch.equal(getattr(sess.state, leaf),
                           getattr(eager.state, leaf)), leaf
    assert (st["captures"], st["replays"], st["block_lengths"]) == (2, 3,
                                                                    [1, 3])
    warm = {k: sum(v.values()) for k, v in st["warmup_launches"].items()}
    assert want["sketch_rows"] == 14 and want["estimate_median"] == 7
    assert len(graph) == 3
    assert replayed == {k: want[k] for k in replayed}
    assert {k: n for k, n in got.items() if n} == warm
    assert captured == {"sketch_rows": 8, "estimate_median": 4}
    assert sess.retrace_sentinel.retraces == 0
    torch.cuda.synchronize()

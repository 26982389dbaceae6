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
"""

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops import countsketch as cs
from commefficient_tpu_torch.ops.cuda import countsketch as kern

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
                     kern._FAMILY[family], w, kern._stream())
        tables.append(t)
    torch.cuda.synchronize()
    assert torch.equal(tables[0], tables[1])
    assert torch.equal(tables[0], kern.sketch_rows(spec, v_s))


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES)
def test_estimate_median_matches_plain_exactly(dev, d, c, r, band, m, family):
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, hash_family=family)
    table = _vec(r * spec.c_actual, 2, dev).reshape(spec.table_shape)
    n0 = kern.estimate_median.launches
    got = kern.estimate_median(spec, table)
    assert kern.estimate_median.launches == n0 + 1
    torch.cuda.synchronize()
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
    want = cs._unscramble(spec, kern.estimate_median(spec, table))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,seed,n", ESTIMATE_AT_GEOMETRIES + [
    (6_573_130, 500_000, 5, 42, None)])
def test_estimate_at_range_matches_plain_and_k2(dev, d, c, r, seed, n,
                                                family):
    """K4's range form, exactly, against its plain version and against K2
    unscrambled, at n = 0, n = 1, a ragged n starting inside a scramble
    block, every coordinate, and the last rank's slice of a four-way
    split (clipped at d - 1)."""
    spec = cs.CountSketch(d=d, c=c, r=r, seed=seed, hash_family=family)
    table = _vec(r * spec.c_actual, seed, dev).reshape(spec.table_shape)
    full = cs._unscramble(spec, kern.estimate_median(spec, table))
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

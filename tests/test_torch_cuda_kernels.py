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
offset) order and the plain ``index_add_`` in position order.
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
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES)
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
@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES)
def test_estimate_median_matches_plain_exactly(dev, d, c, r, band, m, family):
    spec = cs.CountSketch(d=d, c=c, r=r, band=band, m=m, hash_family=family)
    table = _vec(r * spec.c_actual, 2, dev).reshape(spec.table_shape)
    n0 = kern.estimate_median.launches
    got = kern.estimate_median(spec, table)
    assert kern.estimate_median.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, kern.estimate_median_torch(spec, table))


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

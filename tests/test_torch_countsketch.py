"""The port's CountSketch against the reference's, on the CPU.

The reference runs its Pallas kernels in interpret mode (as
tests/test_countsketch_pallas.py does); the port runs the plain PyTorch
versions of its CUDA kernels, which is what a CPU tensor selects. Inputs
are numpy arrays made from a seed. Tolerances:

* geometry integers and hash bits: exact;
* estimates, medians and unsketched updates from the SAME table: exact —
  both sides read one bucket per row, multiply by +-1 and select, with no
  float reduction;
* tables: fp32 summation order differs (the reference contracts a one-hot
  on the matrix unit, the port adds in index order), so ``atol = 3e-6 *
  max|table|``, the reference's own backend-equivalence bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import countsketch as ref
from commefficient_tpu.ops.pallas import median_rows_pallas
from commefficient_tpu_torch.ops import countsketch as port
from commefficient_tpu_torch.ops.cuda import (
    estimate_median,
    median_rows,
    sketch_rows,
)
from commefficient_tpu_torch.ops.topk import topk_sparsify

P31 = 2**31 - 1

GEOMETRIES = [
    # (d, c, r, band, m): ResNet-9's main path, the reference's pallas-test
    # geometries, a tiny TinyMLP-scale one, a padded odd d, GPT-2 small
    (6_573_130, 500_000, 5, 16, None),
    (10_000, 2_000, 5, 16, None),
    (20_011, 4_000, 3, 16, 512),
    (212, 512, 5, 16, None),
    (1_200_003, 48_000, 4, 8, None),
    (124_439_808, 5_000_000, 5, 16, None),
]


def specs(d, c, r, band=16, m=None, family="fmix32", seed=7):
    return (ref.CountSketch(d=d, c=c, r=r, m=m, band=band, seed=seed,
                            hash_family=family, backend="pallas"),
            port.CountSketch(d=d, c=c, r=r, m=m, band=band, seed=seed,
                             hash_family=family))


def assert_table_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=3e-6 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("d,c,r,band,m", GEOMETRIES)
def test_geometry_integers_equal(d, c, r, band, m):
    s_ref, s_port = specs(d, c, r, band, m)
    for name in ("sblock", "d_eff", "chunk_m", "nc", "s", "c_actual",
                 "table_shape"):
        assert getattr(s_port, name) == getattr(s_ref, name), name
    for row in range(r):
        for name in ("_factor", "_L_row", "_nc_row", "u_row", "s_row",
                     "V_row", "_row_key"):
            assert int(getattr(s_port, name)(row)) == int(
                getattr(s_ref, name)(row)), (name, row)
        for purpose in (0, 1):
            np.testing.assert_array_equal(s_port._poly4_coeffs(row, purpose),
                                          s_ref._poly4_coeffs(row, purpose))
    if d < 10**7:  # the 124M permutation costs seconds and adds nothing
        for a, b in zip(port._scramble_perms(s_port.d_eff, s_port.sblock, 7),
                        ref._scramble_perms(s_ref.d_eff, s_ref.sblock, 7)):
            np.testing.assert_array_equal(a, b)


def _operands(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2, P31 - 2, P31 - 1, 2**31, 2**32 - 1], np.uint64)
    return np.concatenate([rng.integers(0, 2**32, size=n).astype(np.uint64),
                           rng.integers(P31 - 4096, P31, size=256).astype(
                               np.uint64), edges])


def test_mix32_bit_equal():
    x = _operands()
    for key in (0, 0x9E3779B9, 0xDEADBEEF, 12345):
        want = np.asarray(ref._mix32(jnp.asarray(x.astype(np.uint32)),
                                     np.uint32(key)))
        got = port.mix32(torch.from_numpy(x.astype(np.int64)), key).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_poly4_bit_equal():
    x = _operands()
    x = x[x < P31]  # the field's domain
    rng = np.random.default_rng(1)
    for _ in range(4):
        coeffs = rng.integers(1, P31, size=4).astype(np.uint64)
        want = ref._poly4_eval(x, coeffs)
        np.testing.assert_array_equal(port._poly4_eval(x, coeffs), want)
        got = port.poly4(torch.from_numpy(x.astype(np.int64)), coeffs)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
        # the reference's in-kernel uint32 limb arithmetic agrees too
        limb = ref._poly4_u32(jnp.asarray(x.astype(np.uint32)),
                              tuple(int(c) for c in coeffs))
        np.testing.assert_array_equal(np.asarray(limb).astype(np.uint64),
                                      want)
    with pytest.raises(ValueError, match="GF"):
        port._poly4_eval(np.array([P31], np.uint64), coeffs)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_cols_signs_match_reference_gather_path(family):
    s_ref, s_port = specs(20_011, 4_000, 3, 16, 512, family)
    idx = np.random.default_rng(2).choice(20_011, size=3000, replace=False)
    for row in range(3):
        cols_r, sign_r = ref._row_cols_signs(
            s_ref, jnp.asarray(idx.astype(np.uint32)), row)
        cols_p, sign_p = port._row_cols_signs(s_port, torch.from_numpy(idx),
                                              row)
        np.testing.assert_array_equal(cols_p.numpy(), np.asarray(cols_r))
        np.testing.assert_array_equal(sign_p.numpy(), np.asarray(sign_r))


def planted(d, k, rng, heavy=100.0):
    v = rng.normal(size=d).astype(np.float32)
    idx = rng.choice(d, size=k, replace=False)
    v[idx] += heavy * rng.choice([-1.0, 1.0], size=k)
    return v, idx


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("r", [1, 3, 4, 5])
def test_sketch_estimate_unsketch_match_pallas(family, r):
    d = 6_007
    s_ref, s_port = specs(d, 1_200, r, 16, None, family)
    rng = np.random.default_rng(r)
    v, hh = planted(d, 12, rng)
    t_ref = np.asarray(ref.sketch_vec(s_ref, jnp.asarray(v)))
    t_port = port.sketch_vec(s_port, torch.from_numpy(v))
    assert t_port.shape == t_ref.shape == s_ref.table_shape
    assert_table_close(t_port, t_ref)
    # from the SAME table, the gather + median is exact on both sides
    e_ref = np.asarray(ref.estimate_all(s_ref, jnp.asarray(t_ref)))
    e_port = port.estimate_all(s_port, torch.tensor(t_ref)).numpy()
    np.testing.assert_array_equal(e_port, e_ref)
    # the reference's unsketch is lax.top_k of these same estimates
    # (reusing them spares a second interpret-mode estimate pass)
    _, top = jax.lax.top_k(jnp.abs(jnp.asarray(e_ref)), 12)
    u_ref = np.zeros(d, np.float32)
    u_ref[np.asarray(top)] = e_ref[np.asarray(top)]
    u_port = port.unsketch(s_port, torch.tensor(t_ref), 12).numpy()
    np.testing.assert_array_equal(u_port, u_ref)
    if r == 5:  # the planted heavy hitters survive the round trip
        assert set(hh.tolist()) <= set(np.nonzero(u_port)[0].tolist())


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_linearity(family):
    _, s_port = specs(10_000, 2_000, 5, 16, None, family)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=10_000).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=10_000).astype(np.float32))
    lhs = port.sketch_vec(s_port, a + b)
    assert_table_close(lhs, port.sketch_vec(s_port, a)
                       + port.sketch_vec(s_port, b))
    # a sparse sketch is the dense sketch of the same vector
    idx = torch.from_numpy(rng.choice(10_000, size=50, replace=False))
    vals = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    dense = torch.zeros(10_000)
    dense[idx] = vals
    assert_table_close(port.sketch_sparse(s_port, idx, vals),
                       port.sketch_vec(s_port, dense))


def test_estimate_at_and_sketch_sparse_match_reference():
    s_ref, s_port = specs(20_011, 4_000, 3, 16, 512)
    rng = np.random.default_rng(4)
    idx = rng.choice(20_011, size=500, replace=False)
    vals = rng.normal(size=500).astype(np.float32)
    t_ref = np.asarray(ref.sketch_sparse(s_ref, jnp.asarray(idx.astype(
        np.uint32)), jnp.asarray(vals)))
    t_port = port.sketch_sparse(s_port, torch.from_numpy(idx),
                                torch.from_numpy(vals)).numpy()
    assert_table_close(t_port, t_ref)
    e_ref = np.asarray(ref.estimate_at(s_ref, jnp.asarray(t_ref),
                                       jnp.asarray(idx.astype(np.uint32))))
    e_port = port.estimate_at(s_port, torch.from_numpy(t_ref),
                              torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(e_port, e_ref)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,sb", [(20_011, 4_000, 3, None),
                                      (20_011, 4_000, 3, 0),
                                      (9_001, 2_000, 5, 8)])
def test_estimate_all_matches_reference_in_original_order(d, c, r, sb,
                                                          family):
    """``estimate_all`` is K2 alone now (the unscramble fused); its plain
    path, the gather, the median and the unscramble, equals the
    reference's ``estimate_all`` exactly from the same table, with the
    scramble, without it, and with a scramble block of 8."""
    s_ref = ref.CountSketch(d=d, c=c, r=r, seed=7, scramble_block=sb,
                            hash_family=family, backend="pallas")
    s_port = port.CountSketch(d=d, c=c, r=r, seed=7, scramble_block=sb,
                              hash_family=family)
    assert s_port.sblock == s_ref.sblock and s_port.d_eff == s_ref.d_eff
    table = np.random.default_rng(d + r).normal(
        size=s_ref.table_shape).astype(np.float32)
    want = np.asarray(ref.estimate_all(s_ref, jnp.asarray(table)))
    got = port.estimate_all(s_port, torch.from_numpy(table))
    assert got.shape == (d,)
    np.testing.assert_array_equal(got.numpy(), want)


RANGE_GEOMETRIES = [
    # (d, c, r, seed): tests/test_decode_blockwise.py's — a table over the
    # reference's 12 MiB single-block guard, its many-block geometry, and
    # a single-block one
    (1_200_003, 1_100_000, 3, 11),
    (50_011, 8_000, 5, 7),
    (10_000, 2_000, 5, 7),
]


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
@pytest.mark.parametrize("d,c,r,seed", RANGE_GEOMETRIES)
def test_estimate_at_range_matches_reference(d, c, r, seed, family):
    """The range form (the sharded decode's slice estimate) equals the
    reference's ``estimate_at`` at the clipped coordinates ``min(start +
    arange(n), d - 1)``, exactly: at the first rank's slice of a four-way
    split, at a slice that starts and ends inside scramble blocks, and at
    the last rank's slice, where the clip at d - 1 bites."""
    s_ref, s_port = specs(d, c, r, family=family, seed=seed)
    table = np.random.default_rng(seed).normal(
        size=s_ref.table_shape).astype(np.float32)
    S, b = -(-d // 4), s_port.sblock
    for start, n in ((0, S), ((d // 2 // b) * b + b // 3, 5 * b + 7),
                     (3 * S, S)):
        idx = np.minimum(start + np.arange(n), d - 1).astype(np.uint32)
        want = np.asarray(ref.estimate_at(s_ref, jnp.asarray(table),
                                          jnp.asarray(idx)))
        got = port.estimate_at_range(s_port, torch.from_numpy(table), start,
                                     n).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 7])
def test_median_rows_matches_pallas(r):
    x = np.random.default_rng(5).normal(size=(r, 3001)).astype(np.float32)
    want = np.asarray(median_rows_pallas(jnp.asarray(x)))
    np.testing.assert_array_equal(median_rows(torch.from_numpy(x)).numpy(),
                                  want)


def test_topk_tie_rule_matches_lax_top_k():
    v = np.array([3.0, -5.0, 5.0, 1.0, -3.0, 5.0, 0.0, 3.0], np.float32)
    for k in range(1, 9):
        want_v, want_i = jax.lax.top_k(jnp.abs(jnp.asarray(v)), k)
        got_v, got_i = topk_sparsify(torch.from_numpy(v), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(np.abs(got_v.numpy()),
                                      np.asarray(want_v))


def test_wrappers_check_their_inputs():
    _, s = specs(10_000, 2_000, 5)
    with pytest.raises(ValueError, match="shape"):
        sketch_rows(s, torch.zeros(s.d_eff + 1))
    with pytest.raises(TypeError, match="float32"):
        estimate_median(s, torch.zeros(s.table_shape, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        median_rows(torch.zeros(10, 3).t())


# -- the bf16 forms (tests/test_countsketch_bf16.py's cases) ---------------------

BF16_D, BF16_C, BF16_R = 10_000, 2_000, 5
BF16_FORMS = [  # (table dtype, operand dtype)
    ("float32", "bfloat16"), ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
]


def _bf16_specs(table, operand):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    geo = dict(d=BF16_D, c=BF16_C, r=BF16_R, seed=7)
    return (ref.CountSketch(**geo, dtype=jd[operand], table_dtype=jd[table]),
            port.CountSketch(**geo, dtype=td[operand], table_dtype=td[table]))


@pytest.mark.parametrize("table,operand", BF16_FORMS)
def test_bf16_plain_ops_match_reference_einsum_backend(table, operand):
    """The plain versions of the bf16 forms against the reference's einsum
    backend: the sketch (operands rounded to bf16 before the f32 sums, the
    table rounded at the end) to one bf16 ulp of each entry (the two sum
    in another fp32 order, which can put a sum on either side of a bf16
    rounding boundary; floor 1e-6 * max for sums that cancel), and the
    f32-table form at the f32 bound; the estimates from the reference's
    own table exactly (one entry per row, read as the operand type: a bf16
    table widens, an f32 table rounds when the operand is bf16);
    ``estimate_at`` only widens; ``sketch_sparse`` never rounds."""
    s_ref, s_port = _bf16_specs(table, operand)
    rng = np.random.default_rng(1)
    v = rng.normal(size=BF16_D).astype(np.float32)
    t_ref = np.array(ref.sketch_vec(s_ref, jnp.asarray(v)), np.float32)
    t_port = port.sketch_vec(s_port, torch.from_numpy(v))
    assert t_port.dtype == s_port.table_dtype
    got = t_port.float().numpy()
    if table == "bfloat16":
        bound = 2.0**-7 * np.abs(t_ref) + 1e-6 * np.abs(t_ref).max()
        assert np.all(np.abs(got - t_ref) <= bound)
    else:
        np.testing.assert_allclose(got, t_ref, rtol=0,
                                   atol=3e-6 * np.abs(t_ref).max())
    # the same table through both estimates: exact
    tab = torch.from_numpy(t_ref).to(s_port.table_dtype)
    e_ref = np.asarray(ref.estimate_all(
        s_ref, jnp.asarray(t_ref).astype(s_ref.table_dtype)))
    np.testing.assert_array_equal(port.estimate_all(s_port, tab).numpy(),
                                  e_ref)
    idx = rng.choice(BF16_D, size=300, replace=False).astype(np.int64)
    a_ref = np.asarray(ref.estimate_at(
        s_ref, jnp.asarray(t_ref).astype(s_ref.table_dtype),
        jnp.asarray(idx, jnp.uint32)))
    np.testing.assert_array_equal(
        port.estimate_at(s_port, tab, torch.from_numpy(idx)).numpy(), a_ref)
    vals = rng.normal(size=300).astype(np.float32)
    sp_ref = np.asarray(ref.sketch_sparse(s_ref, jnp.asarray(
        idx, jnp.uint32), jnp.asarray(vals)))
    sp_port = port.sketch_sparse(s_port, torch.from_numpy(idx),
                                 torch.from_numpy(vals))
    assert sp_port.dtype == torch.float32
    np.testing.assert_allclose(sp_port.numpy(), sp_ref, rtol=0,
                               atol=3e-6 * np.abs(sp_ref).max())


def test_bf16_linearity_zero_and_roundtrip():
    """The reference's bf16 properties through the port: linearity within
    the rounding of three bf16 tables (2e-2 * max, the reference's
    bound), a zero vector sketches to exact zeros, and planted heavy
    hitters come back to a few percent (bf16 ulp at 100 is 0.5)."""
    _, spec = _bf16_specs("bfloat16", "float32")
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.normal(size=BF16_D).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=BF16_D).astype(np.float32))
    ta, tb, tab = (port.sketch_vec(spec, x) for x in (a, b, a + b))
    assert ta.dtype == tb.dtype == tab.dtype == torch.bfloat16
    rhs = tab.float()
    torch.testing.assert_close(ta.float() + tb.float(), rhs, rtol=0,
                               atol=2e-2 * float(rhs.abs().max()))
    assert torch.all(port.sketch_vec(spec, torch.zeros(BF16_D)) == 0)
    v = rng.normal(0, 1.0, size=BF16_D).astype(np.float32)
    hh = rng.choice(BF16_D, size=10, replace=False)
    v[hh] += 100.0 * rng.choice([-1.0, 1.0], size=10)
    est = port.estimate_all(spec, port.sketch_vec(spec, torch.from_numpy(v)))
    assert est.dtype == torch.float32
    top = torch.argsort(-est.abs())[:32]
    assert set(hh.tolist()) <= set(top.tolist())
    np.testing.assert_allclose(est.numpy()[hh], v[hh], rtol=5e-2)

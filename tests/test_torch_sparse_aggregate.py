"""The port's remaining decode options and sparse aggregation against the
reference, on the CPU.

What is held against the JAX package, with inputs made from numpy seeds:

* ``estimate_all`` at ``num_blocks`` 1, 4 and 7 (the blockwise gather
  estimate over coordinate slices, the last padded by repeating d - 1):
  bit for bit, and bit-equal across ``num_blocks`` in the port;
* ``topk_method='approx'``: the port runs its exact ``topk_sparsify``,
  ``topk_dense`` and ``unsketch``, held bit for bit against the
  reference's ``approx=True`` forms (``lax.approx_max_k``, which off a TPU
  is the exact selection, ties included);
* ``ops/collectives`` on two gloo ranks against the reference's 2-device
  ``shard_map``, bit for bit: ``sparse_allreduce`` (the rank-by-rank
  scatter is the reference's in-order scatter), the butterfly
  ``sparse_allreduce_sharded``, ``all_gather_pairs(segments=4)`` equal to
  the monolithic gather, ``psum_segments`` equal to one fused sum; the
  butterfly also on four ranks (one more spawn), and its two-level order
  within 1e-6 of the dense sum;
* four-round TinyMLP sessions at ``num_devices=2`` (two gloo ranks, the
  reference's 2-device mesh; losses ``rtol 1e-4``, params ``atol 1e-5``,
  server leaves ``atol 1e-5 * max|leaf|``, as
  tests/test_torch_sharded_decode.py holds its twins): local_topk under
  ``aggregate='auto'`` with the threshold top-k, which must resolve
  ``sparse`` as the reference does (ROADMAP C.3), true_topk sparse (its
  state sharded over the ranks, compared in the full padded layout),
  sketch sparse (the error feedback riding the pair exchange), and the
  fused sketch backward with ``overlap_collectives='layerwise'`` (held to
  the one-process dense-grad fused round at the fused backward's bound,
  ``5e-5 * max|params|``: the reference's fused backward is held outside
  ``shard_map`` only); local_topk sparse with the segmented gathers
  bit-equal to the monolithic run; a resumed sharded-state run bit-equal
  to the straight one;
* the layerwise fused backward's group tables against the reference's
  ``make_sketch_grad_one(overlap_segments=4)`` outside ``shard_map``
  (``1e-5 * max|table|``), and their sum against the monolithic table;
* ``leaf_groups`` and ``_segment_bounds``, integer for integer;
* ``aggregate_resolved`` for local_topk, true_topk and sketch at one and
  two devices, and the one-device warning of an explicit ``sparse``.

The two-rank sessions and collectives run in one spawn of
tests/test_torch_gloo_worker.py (``spawn`` caches it, so
tests/test_torch_fsdp.py, which asks for the same job, shares it).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import countsketch as ref_cs
from commefficient_tpu.ops import topk as ref_topk
from commefficient_tpu.ops.collectives import (
    all_gather_pairs as ref_all_gather_pairs,
)
from commefficient_tpu.ops.collectives import (
    sparse_allreduce as ref_sparse_allreduce,
)
from commefficient_tpu.ops.collectives import (
    sparse_allreduce_sharded as ref_sparse_allreduce_sharded,
)
from commefficient_tpu.ops.collectives.sparse_allreduce import (
    _segment_bounds as ref_segment_bounds,
)
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.parallel.mesh import WORKERS, make_mesh
from commefficient_tpu.parallel.round import leaf_groups as ref_leaf_groups
from commefficient_tpu.parallel.round import (
    make_sketch_grad_one as ref_make_sketch_grad_one,
)
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu.utils.jax_compat import shard_map
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops import countsketch as port_cs
from commefficient_tpu_torch.ops import topk as port_topk
from commefficient_tpu_torch.ops.collectives import (
    scatter_add_pairs,
    sparse_allreduce_sharded,
)
from commefficient_tpu_torch.ops.collectives.sparse_allreduce import (
    _segment_bounds,
)
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.round import (
    leaf_groups,
    make_sketch_grad_one,
)
from commefficient_tpu_torch.utils.config import Config
from test_round import BASE
from test_torch_gloo_worker import spawn
from test_torch_model import to_numpy_tree, torch_tinymlp
from test_torch_sharded_decode import (  # noqa: F401  (the fixture)
    LR,
    _assert_twin,
    _port_run,
    _split,
    rounds,
)

P = jax.sharding.PartitionSpec

LOCAL = dict(mode="local_topk", k=7, topk_method="threshold",
             error_type="local")
TRUE = dict(mode="true_topk", k=9, topk_method="threshold",
            error_type="virtual", virtual_momentum=0.9)
SKETCH = dict(mode="sketch", k=40, num_rows=3, num_cols=256,
              error_type="virtual", virtual_momentum=0.9,
              topk_method="threshold")
FUSED_LAYERWISE = dict(mode="sketch", k=40, num_rows=3, num_cols=256,
                       error_type="virtual", virtual_momentum=0.9,
                       fuse_clients=True, sketch_fused_bwd=True,
                       weight_decay=1e-4)
# the two-rank sessions: name -> Config keywords over BASE at 2 devices
TWO_RANK_CASES = {
    "local_topk_auto": LOCAL,
    "local_topk_sparse_segments": {**LOCAL, "aggregate": "sparse",
                                   "overlap_collectives": "layerwise"},
    "true_topk_sparse": {**TRUE, "aggregate": "sparse"},
    "true_topk_sparse_dampen": {**TRUE, "aggregate": "sparse",
                                "momentum_dampening": True},
    "sketch_sparse": {**SKETCH, "aggregate": "sparse"},
    "sketch_fused_layerwise": {**FUSED_LAYERWISE,
                               "overlap_collectives": "layerwise"},
    "fsdp_sketch": {**SKETCH, "fsdp": True},
    "fsdp_true_topk": {**TRUE, "fsdp": True},
    "fsdp_uncompressed": dict(mode="uncompressed", virtual_momentum=0.9,
                              topk_method="threshold", fsdp=True),
}
RESUME_CASES = ("true_topk_sparse", "fsdp_true_topk")
# the reference twins of the sessions (the layerwise fused round and the
# segmented run are held otherwise, see their tests)
REF_TWINS = sorted(n for n in TWO_RANK_CASES if not n.startswith("fsdp")
                   and n not in ("sketch_fused_layerwise",
                                 "local_topk_sparse_segments"))
COLL = dict(d=257, k=6, capacity=6)


def _coll_vectors(world, d=COLL["d"], k=COLL["k"], seed=0):
    """``world`` k-sparse rows over overlapping supports."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((world, d), np.float32)
    for w in range(world):
        sup = rng.choice(d // 2, size=k, replace=False)
        dense[w, sup] = rng.normal(size=k).astype(np.float32)
    return dense


def job_arrays(rounds_, world=2):
    """The input file of the spawned ranks: TinyMLP's initial params, the
    4 rounds' ids and batches, and the collectives' rows."""
    _, params, _, batches = rounds_
    arrays = {f"{layer}/{leaf}": np.asarray(params["params"][layer][leaf])
              for layer in ("Dense_0", "Dense_1")
              for leaf in ("kernel", "bias")}
    arrays["ids"] = np.stack([ids for ids, _ in batches])
    arrays["x"] = np.stack([b["x"] for _, b in batches])
    arrays["y"] = np.stack([b["y"] for _, b in batches])
    arrays["coll/v"] = _coll_vectors(world)
    return arrays


def two_rank_job():
    two = {**BASE, "num_devices": 2}
    return {"lr": LR,
            "cases": {n: {**two, **kw} for n, kw in TWO_RANK_CASES.items()},
            "resume": {n: {**two, **TWO_RANK_CASES[n]}
                       for n in RESUME_CASES},
            "collectives": COLL}


@pytest.fixture(scope="module")
def two_ranks(rounds, tmp_path_factory):
    return spawn(two_rank_job(), job_arrays(rounds), 2, tmp_path_factory)


def ranks_case(outs, name):
    """Rank 0's outputs for one case, after checking every other rank
    holds the same full-layout state bit for bit."""
    keys = [k for k in outs[0] if k.startswith(name + "/")]
    for out in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k])
    return {k.split("/", 1)[1]: outs[0][k] for k in keys}


def _without_vma_check(shard_map_fn):
    """The reference's ``shard_map`` with the static replication check off
    for its round's worker and decode bodies. The check cannot infer that
    a sparse exchange's output (an all_gather then a scatter) is
    replicated and, on some JAX versions (0.9.0 among them), refuses the
    program, the reference's own tests/test_sparse_aggregate.py with it;
    the values are unaffected (tests/test_torch_sharded_decode.py's
    ``_decode_without_vma_check`` has the decode's case)."""

    def patched(f, **kw):
        if getattr(f, "__name__", "") in ("worker_shard", "decode_shard"):
            kw["check_vma"] = False
        return shard_map_fn(f, **kw)

    return patched


def ref_run(rounds_, kw):
    """The reference session over the 4 rounds: losses, params ([D]),
    server leaves as ``np.asarray`` gives them (a sharded leaf whole and
    padded) and the resolved aggregation."""
    import commefficient_tpu.parallel.round as ref_round

    _, params, loss_ref, batches = rounds_
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_round, "shard_map",
                   _without_vma_check(ref_round.shard_map))
        cfg = RefConfig(**kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sess = RefSession(cfg, params, loss_ref)
        losses = [float(sess.train_round(ids, _split(cfg, b), LR)["loss"])
                  for ids, b in batches]
    st = sess.state
    return dict(losses=np.asarray(losses),
                params=np.asarray(st.params_vec)[:sess.grad_size],
                momentum=np.asarray(st.momentum), error=np.asarray(st.error),
                aggregate=sess.aggregate_resolved)


# -- num_blocks (A15a) ---------------------------------------------------------


@pytest.mark.parametrize("num_blocks", [1, 4, 7])
@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_estimate_all_num_blocks_matches_reference(num_blocks, family):
    geo = dict(d=20_011, c=4_000, r=3, m=512, seed=7, hash_family=family)
    s_ref = ref_cs.CountSketch(num_blocks=num_blocks, **geo)
    s_port = port_cs.CountSketch(num_blocks=num_blocks, **geo)
    table = np.random.default_rng(num_blocks).normal(
        size=s_ref.table_shape).astype(np.float32)
    want = np.asarray(ref_cs.estimate_all(s_ref, jnp.asarray(table)))
    got = port_cs.estimate_all(s_port, torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, want)
    one = port_cs.estimate_all(port_cs.CountSketch(num_blocks=1, **geo),
                               torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, one)  # the reference's invariance


def test_num_blocks_beyond_d_and_refusal():
    """More blocks than a slice can fill (the tail blocks start past d)
    and a refused ``num_blocks = 0``."""
    geo = dict(d=5, c=64, r=3, m=8, seed=1)
    table = torch.from_numpy(np.random.default_rng(0).normal(
        size=port_cs.CountSketch(**geo).table_shape).astype(np.float32))
    want = port_cs.estimate_all(port_cs.CountSketch(**geo), table)
    got = port_cs.estimate_all(port_cs.CountSketch(num_blocks=4, **geo),
                               table)
    assert torch.equal(got, want)
    ref = np.asarray(ref_cs.estimate_all(
        ref_cs.CountSketch(num_blocks=4, **geo), jnp.asarray(table.numpy())))
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="num_blocks"):
        port_cs.CountSketch(num_blocks=0, **geo)
    with pytest.raises(ValueError, match="num_blocks"):
        Config(num_blocks=0)


# -- approx (A15b) -------------------------------------------------------------


APPROX_VECTORS = {  # name -> (vector, k)
    "random": (np.random.default_rng(0).normal(size=4000), 100),
    "ties": (np.random.default_rng(1).integers(-5, 6, 4000), 300),
    "k_equals_n": (np.random.default_rng(2).normal(size=64), 64),
}


@pytest.mark.parametrize("name", sorted(APPROX_VECTORS))
def test_topk_approx_matches_approx_max_k(name):
    v, k = APPROX_VECTORS[name]
    v = v.astype(np.float32)
    want_v, want_i = ref_topk.topk_sparsify(jnp.asarray(v), k, approx=True)
    got_v, got_i = port_topk.topk_sparsify(torch.from_numpy(v), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    want = np.asarray(ref_topk.topk_dense(jnp.asarray(v), k, approx=True))
    got = port_topk.topk_dense(torch.from_numpy(v), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_unsketch_approx_matches_reference():
    geo = dict(d=20_011, c=4_000, r=3, m=512, seed=7)
    s_ref, s_port = ref_cs.CountSketch(**geo), port_cs.CountSketch(**geo)
    table = np.random.default_rng(5).normal(
        size=s_ref.table_shape).astype(np.float32)
    want = np.asarray(ref_cs.unsketch(s_ref, jnp.asarray(table), 300,
                                      approx=True))
    got = port_cs.unsketch(s_port, torch.from_numpy(table), 300).numpy()
    np.testing.assert_array_equal(got, want)


# one-device sessions of the decode options against the reference
ONE_DEVICE_CASES = {
    "sketch_num_blocks_4": {**SKETCH, "topk_method": "exact",
                            "num_blocks": 4},
    "sketch_approx": {**SKETCH, "topk_method": "approx"},
    "local_topk_approx": {**LOCAL, "topk_method": "approx",
                          "local_momentum": 0.9},
    "true_topk_approx": {**TRUE, "topk_method": "approx"},
}


@pytest.mark.parametrize("name", sorted(ONE_DEVICE_CASES))
def test_decode_option_sessions_match_reference(rounds, name):
    kw = {**BASE, "num_devices": 1, **ONE_DEVICE_CASES[name]}
    want = ref_run(rounds, kw)
    got = _port_run(rounds, kw)
    _assert_twin(got, want)
    if "num_blocks" in kw:  # the port's num_blocks = 4 is its = 1, bitwise
        one = _port_run(rounds, {**kw, "num_blocks": 1})
        np.testing.assert_array_equal(got["params"], one["params"])
        np.testing.assert_array_equal(got["error"], one["error"])
    if kw["topk_method"] == "approx":  # approx is the exact selection
        exact = _port_run(rounds, {**kw, "topk_method": "exact"})
        np.testing.assert_array_equal(got["params"], exact["params"])


# -- resolution ----------------------------------------------------------------


def _resolved(rounds_, kw):
    _, params, _, _ = rounds_
    sess = FederatedSession(Config(**kw, device="cpu"), to_numpy_tree(params),
                            classification_loss(torch_tinymlp))
    return sess.aggregate_resolved


@pytest.mark.parametrize("mode_kw", [LOCAL, TRUE, SKETCH],
                         ids=["local_topk", "true_topk", "sketch"])
def test_aggregate_resolved_one_device_matches_reference(rounds, mode_kw):
    _, params, loss_ref, _ = rounds
    for agg in ("auto", "dense"):
        kw = {**BASE, "num_devices": 1, **mode_kw, "aggregate": agg}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = RefSession(RefConfig(**kw), params,
                              loss_ref).aggregate_resolved
        assert _resolved(rounds, kw) == want == "dense"
    kw = {**BASE, "num_devices": 1, **mode_kw, "aggregate": "sparse"}
    with pytest.warns(UserWarning, match="degenerate"):
        assert _resolved(rounds, kw) == "sparse"


@pytest.mark.parametrize("name", ["local_topk_sparse", "true_topk_sparse"])
def test_explicit_sparse_one_device_matches_reference(rounds, name):
    kw = {**BASE, "num_devices": 1, "aggregate": "sparse",
          **(LOCAL if name.startswith("local") else TRUE)}
    want = ref_run(rounds, kw)
    with pytest.warns(UserWarning, match="degenerate"):
        got = _port_run(rounds, kw)
    _assert_twin(got, want)


# -- collectives on one process ------------------------------------------------


@pytest.mark.parametrize("n,segments", [(1, 4), (3, 4), (4, 4), (17, 4),
                                        (100, 1), (100, 7)])
def test_segment_bounds_match_reference(n, segments):
    assert _segment_bounds(n, segments) == ref_segment_bounds(n, segments)


@pytest.mark.parametrize("sizes,segments", [
    ([10, 10, 10, 10], 4), ([1, 1, 1], 8), ([100, 1, 1, 1, 1], 3), ([5], 4),
    (list(range(1, 20)), 4)])
def test_leaf_groups_match_reference(sizes, segments):
    assert leaf_groups(sizes, segments) == ref_leaf_groups(sizes, segments)


def test_scatter_add_pairs_contract():
    """Repeats accumulate (across buffers, in buffer order), the (0, 0.0)
    pads add nothing: the reference's example, and two buffers."""
    out = scatter_add_pairs(6, torch.tensor([2, 2, 5, 0, 0]),
                            torch.tensor([1.0, 2.5, -1.0, 0.0, 0.0]))
    assert out.tolist() == [0.0, 0.0, 3.5, 0.0, 0.0, -1.0]
    out = scatter_add_pairs(4, torch.tensor([1, 3, 0, 1]),
                            torch.tensor([0.5, 2.0, 0.0, 0.25]), buffers=2)
    assert out.tolist() == [0.0, 0.75, 0.0, 2.0]


def test_sparse_allreduce_sharded_refuses_other_group_sizes():
    class Six:
        rank, size = 0, 6

    with pytest.raises(ValueError, match="power-of-two"):
        sparse_allreduce_sharded(torch.zeros(16), 4, Six())
    with pytest.raises(ValueError, match="power-of-two"):
        sparse_allreduce_sharded(torch.zeros(16), 4, Six(),
                                 axis_sizes=(2, 3))


# -- the layerwise fused backward ----------------------------------------------


def test_layerwise_group_tables_match_reference(rounds):
    """The per-group tables against the reference's
    ``make_sketch_grad_one(overlap_segments=4)`` outside ``shard_map``,
    each reported once as its group completes, and their sum within the
    fused backward's bound of the monolithic table."""
    from jax.flatten_util import ravel_pytree

    ds, params, loss_ref, batches = rounds
    kw = {**BASE, "num_devices": 1, **FUSED_LAYERWISE}
    vec, unravel = ravel_pytree(params)
    d = int(vec.size)
    ref_spec = ref_cs.CountSketch(d=d, c=256, r=3, seed=BASE["seed"])
    ref_fn = ref_make_sketch_grad_one(RefConfig(**kw), loss_ref, unravel,
                                      None, ref_spec, d=d,
                                      overlap_segments=4)
    _, batch = batches[0]
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
    want, want_loss, _ = jax.jit(ref_fn)(
        vec, jax.tree.map(jnp.asarray, flat), jax.random.key(0))
    pvec, punravel = ravel_params(to_numpy_tree(params))
    spec = port_cs.CountSketch(d=d, c=256, r=3, seed=BASE["seed"])
    cfg = Config(**kw, device="cpu")
    loss_fn = classification_loss(torch_tinymlp)
    seen = []
    fn = make_sketch_grad_one(cfg, loss_fn, punravel, spec, d,
                              overlap_segments=4)
    tables, loss, _ = fn(pvec, {k: torch.from_numpy(v)
                                for k, v in flat.items()},
                         on_group=lambda g, t: seen.append(g))
    assert sorted(seen) == list(range(len(tables))) == list(range(len(want)))
    for got, ref in zip(tables, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    mono, _, _ = make_sketch_grad_one(cfg, loss_fn, punravel, spec, d)(
        pvec, {k: torch.from_numpy(v) for k, v in flat.items()})
    total = sum(tables[1:], tables[0])
    np.testing.assert_allclose(total.numpy(), mono.numpy(), rtol=0,
                               atol=1e-5 * max(float(mono.abs().max()), 1.0))


# -- two gloo ranks ------------------------------------------------------------


def _ref_collectives(dense, fn):
    world = dense.shape[0]
    f = shard_map(lambda v: fn(v[0])[None], mesh=make_mesh(world),
                  in_specs=(P(WORKERS),), out_specs=P(WORKERS))
    return np.asarray(jax.jit(f)(jnp.asarray(dense)))


def _hold_collectives(outs, world):
    dense = _coll_vectors(world)
    k, cap = COLL["k"], COLL["capacity"]
    want = _ref_collectives(dense, lambda v: ref_sparse_allreduce(
        v, cap, WORKERS))
    want_sh = _ref_collectives(dense, lambda v: ref_sparse_allreduce_sharded(
        v, k, WORKERS, axis_size=world))
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["coll/sparse"], want[rank])
        np.testing.assert_array_equal(out["coll/sparse_seg"], want[rank])
        np.testing.assert_array_equal(out["coll/sharded"], want_sh[rank])
        np.testing.assert_allclose(out["coll/sparse"], dense.sum(0),
                                   atol=1e-6)
        for part in ("idx", "val"):
            np.testing.assert_array_equal(out[f"coll/gather_{part}_4"],
                                          out[f"coll/gather_{part}_None"])
        assert bool(out["coll/psum_segments_equal"])
        np.testing.assert_allclose(out["coll/psum_segments"], dense.sum(0),
                                   atol=1e-6)
    f = shard_map(lambda v: tuple(a[None] for a in ref_all_gather_pairs(
        *ref_topk.compact_nonzero(v[0], cap), WORKERS)),
        mesh=make_mesh(world), in_specs=(P(WORKERS),),
        out_specs=(P(WORKERS), P(WORKERS)))
    g_i, g_v = jax.jit(f)(jnp.asarray(dense))
    np.testing.assert_array_equal(outs[0]["coll/gather_idx_None"],
                                  np.asarray(g_i)[0])
    np.testing.assert_array_equal(outs[0]["coll/gather_val_None"],
                                  np.asarray(g_v)[0])


def test_collectives_two_gloo_ranks_match_reference(two_ranks):
    _hold_collectives(two_ranks, 2)


@pytest.mark.parametrize("name", REF_TWINS)
def test_sessions_two_gloo_ranks_match_reference(rounds, two_ranks, name):
    kw = {**BASE, "num_devices": 2, **TWO_RANK_CASES[name]}
    want = ref_run(rounds, kw)
    got = ranks_case(two_ranks, name)
    assert str(got["aggregate"]) == want["aggregate"]
    assert bool(got["interop_roundtrip"])  # full layout -> numpy -> slices
    _assert_twin(got, want)


def test_local_topk_auto_resolves_sparse_two_gloo_ranks(two_ranks):
    """ROADMAP C.3: at two devices with the threshold top-k, auto takes
    local_topk's pair exchange, as the reference's rule does; true_topk
    and sketch stay dense under auto."""
    assert str(ranks_case(two_ranks, "local_topk_auto")["aggregate"]) == \
        "sparse"
    for name in ("true_topk_sparse", "sketch_sparse"):
        assert str(ranks_case(two_ranks, name)["aggregate"]) == "sparse"


def test_auto_leaves_true_topk_and_sketch_dense_two_devices(rounds):
    _, params, loss_ref, _ = rounds
    for mode_kw in (TRUE, SKETCH):
        kw = {**BASE, "num_devices": 2, **mode_kw}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = RefSession(RefConfig(**kw), params, loss_ref)
        assert ref.aggregate_resolved == "dense"
        port = FederatedSession(Config(**{**kw, "num_devices": 1},
                                       device="cpu"),
                                to_numpy_tree(params),
                                classification_loss(torch_tinymlp))
        assert port.compressor.use_sparse_aggregate(2) is False


def test_segmented_pair_gathers_bit_equal_two_gloo_ranks(two_ranks):
    seg = ranks_case(two_ranks, "local_topk_sparse_segments")
    mono = ranks_case(two_ranks, "local_topk_auto")
    for key in ("losses", "params", "client_err"):
        np.testing.assert_array_equal(seg[key], mono[key])


def test_layerwise_fused_two_gloo_ranks(rounds, two_ranks):
    """Two ranks of the layerwise fused backward against one process's
    dense-grad fused round, at the fused backward's bound."""
    got = ranks_case(two_ranks, "sketch_fused_layerwise")
    want = _port_run(rounds, {**BASE, "num_devices": 1, **FUSED_LAYERWISE,
                              "sketch_fused_bwd": False})
    scale = max(np.abs(want["params"]).max(), 1.0)
    np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                               atol=5e-5 * scale)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


@pytest.mark.parametrize("name", RESUME_CASES)
def test_sharded_state_resume_bit_exact_two_gloo_ranks(two_ranks, name):
    straight = ranks_case(two_ranks, name)
    resumed = ranks_case(two_ranks, f"resume:{name}")
    for key in ("losses", "params", "momentum", "error"):
        np.testing.assert_array_equal(resumed[key], straight[key])


# -- four gloo ranks -----------------------------------------------------------


@pytest.fixture(scope="module")
def four_ranks(rounds, tmp_path_factory):
    job = {"lr": LR, "collectives": {**COLL, "two_level": [2, 2]}}
    arrays = {"coll/v": _coll_vectors(4)}
    return spawn(job, arrays, 4, tmp_path_factory)


def test_collectives_four_gloo_ranks_match_reference(four_ranks):
    _hold_collectives(four_ranks, 4)
    dense = _coll_vectors(4)
    S = -(-dense.shape[1] // 4)
    want = np.pad(dense.sum(0), (0, 4 * S - dense.shape[1]))
    for rank, out in enumerate(four_ranks):
        np.testing.assert_allclose(out["coll/two_level"],
                                   want[rank * S:(rank + 1) * S], atol=1e-6)

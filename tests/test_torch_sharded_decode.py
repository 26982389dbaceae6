"""The port's sharded sketch decode against the reference, on the CPU.

What is held against the JAX package (its Pallas kernels in interpret
mode, its sessions on the virtual CPU mesh of tests/conftest.py):

* four-round TinyMLP sessions with ``sketch_decode='sharded'`` and the
  threshold top-k, over tests/test_sketch_decode.py's ``DECODE_CASES``:
  at one device, and at two devices, where the port runs two gloo
  processes (tests/test_torch_gloo_worker.py) and the reference a
  2-device mesh. Losses ``rtol 1e-4``; params ``atol 1e-5`` and tables
  ``atol 1e-5 * max|table|`` (the port sums client gradients and sketch
  buckets in another fp32 order; the reference's own single-vs-multi
  device bounds in tests/test_round.py);
* the golden recordings ``sketch`` and ``sketch_threshold`` of
  tests/golden/registry_parity.npz, at the same tolerances;
* ``estimate_at`` and its plain version against ``estimate_at_pallas``
  on both of its branches (single block, and many column blocks forced by
  a small budget as tests/test_decode_blockwise.py does): bit for bit;
* ``topk_threshold_dense``, ``topk_threshold_sharded`` (two gloo ranks)
  and ``compact_nonzero``: bit for bit, the degenerate tie included;
* ``sketch_sparse`` at ``atol 1e-6`` (summation order only);
* ``local_topk`` (client banks) and ``fedavg`` on two gloo ranks against
  the reference's 2-device mesh, the ranks' banks bit for bit equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import countsketch as ref_cs
from commefficient_tpu.ops import topk as ref_topk
from commefficient_tpu.ops.pallas import decode_kernels as dk
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.parallel.mesh import WORKERS, make_mesh
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu.utils.jax_compat import shard_map
from commefficient_tpu_torch.compress import get_compressor
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops import countsketch as port_cs
from commefficient_tpu_torch.ops import topk as port_topk
from commefficient_tpu_torch.ops.cuda import estimate_at as estimate_at_kernel
from commefficient_tpu_torch.ops.cuda import estimate_at_torch
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.mesh import make_worker_group
from commefficient_tpu_torch.utils.config import Config
from test_compress_parity import GOLDEN, GOLDEN_CONFIGS
from test_round import BASE, _setup
from test_sketch_decode import DECODE_CASES, SKETCH
from test_torch_model import to_numpy_tree, torch_tinymlp

HERE = os.path.dirname(os.path.abspath(__file__))
LR = 0.2
N_ROUNDS = 4
SHARDED = {**SKETCH, "sketch_decode": "sharded"}
# the dampening branch (K4 twice a round) at one device, as the reference's
# test_dampening_e2e_dense_matches_sharded runs it
ONE_DEVICE_CASES = {
    **DECODE_CASES,
    "virtual_rho_dampen": dict(error_type="virtual", virtual_momentum=0.9,
                               momentum_dampening=True,
                               allow_unstable_sketch_dampening=True),
}
TOPK_VECTORS = {  # name -> (vector, k)
    "random": (np.random.default_rng(0).normal(size=4000), 100),
    "integer_ties": (np.random.default_rng(1).integers(-5, 6, 4000), 300),
    "degenerate": (np.where(np.arange(4000) % 64 == 0, 1.0, 0.0), 30),
    "zero": (np.zeros(4000), 10),
    "k_above_n": (np.random.default_rng(2).normal(size=100), 500),
}
# the client-state modes on two ranks (tests/test_torch_compressors.py
# holds them at one device)
CLIENT_STATE_CASES = {
    "local_topk_two_ranks": dict(mode="local_topk", error_type="local",
                                 local_momentum=0.9, k=30),
    "fedavg_two_ranks": dict(mode="fedavg", num_local_iters=2),
}
# fedsim masking on two ranks: each rank masks its 4 of the 8 clients by
# its slice of the session's own [W] masks, the live count stays global
FEDSIM_CASES = {
    "sketch_sharded_fedsim_two_ranks": dict(
        **SHARDED, error_type="virtual", virtual_momentum=0.9,
        availability="bernoulli", dropout_prob=0.5, chaos="straggler@0.2"),
    "local_topk_fedsim_two_ranks": dict(
        mode="local_topk", error_type="local", local_momentum=0.9, k=30,
        availability="bernoulli", dropout_prob=0.5),
}
# the sketch-fused backward on two ranks (each rank's table of its
# flattened batch, summed over the group), held to the one-process
# dense-grad fused round: the reference's fused backward does not trace
# inside shard_map under jax 0.9.0, so it is no anchor here
FUSED_BWD_TWO_RANKS = dict(**SKETCH, error_type="virtual",
                           virtual_momentum=0.9, fuse_clients=True,
                           sketch_decode="dense", weight_decay=1e-4)
TIES = dict(d=4096, c=32768, r=3,
            config=dict(mode="sketch", error_type="none", k=30, num_rows=3,
                        num_cols=32768, topk_method="threshold",
                        sketch_decode="sharded", num_clients=12,
                        num_workers=8, num_devices=2, local_batch_size=4))


@pytest.fixture(scope="module")
def rounds():
    """(dataset, initial params, reference loss, the 4 rounds' batches),
    the port's sampler pinned to draw what the reference's draws. The
    params come from the non-partitionable threefry PRNG, the JAX default
    when tests/golden/registry_parity.npz was recorded (JAX 0.5 made the
    partitionable one the default, which draws other initial params)."""
    from commefficient_tpu.data import FedSampler as RefSampler

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        ds, params, loss_ref = _setup(BASE["num_clients"])
        params = jax.tree.map(np.asarray, params)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    ref_s = RefSampler(ds, num_workers=8, local_batch_size=4, seed=1)
    port_s = FedSampler(FedDataset(ds.data, BASE["num_clients"], iid=True,
                                   seed=0), num_workers=8, local_batch_size=4,
                        seed=1)
    batches = []
    for r in range(N_ROUNDS):
        ids, batch = ref_s.sample_round(r)
        ids_p, batch_p = port_s.sample_round(r)
        np.testing.assert_array_equal(ids_p, ids)
        for k in batch:
            np.testing.assert_array_equal(batch_p[k], batch[k])
        batches.append((ids_p, batch_p))
    return ds, params, loss_ref, batches


def _decode_without_vma_check(shard_map_fn):
    """The reference's ``shard_map`` with the static replication check off
    for the sharded decode alone. On JAX 0.9 that check cannot infer that
    the decode's all_gather/psum outputs are replicated and refuses the
    program (tests/test_sketch_decode.py fails the same way); the values
    are unaffected: with the check off the reference's sharded decode
    equals its dense decode to ~6e-8 at 1, 2 and 8 devices."""

    def patched(f, **kw):
        if getattr(f, "__name__", "") == "decode_shard":
            kw["check_vma"] = False
        return shard_map_fn(f, **kw)

    return patched


def _ref_run(rounds, kw):
    import commefficient_tpu.parallel.round as ref_round

    _, params, loss_ref, batches = rounds
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_round, "shard_map",
                   _decode_without_vma_check(ref_round.shard_map))
        cfg = RefConfig(**kw)
        sess = RefSession(cfg, params, loss_ref)
        losses = [float(sess.train_round(ids, _split(cfg, b), LR)["loss"])
                  for ids, b in batches]
    st = sess.state
    return dict(losses=np.asarray(losses), params=np.asarray(st.params_vec),
                momentum=np.asarray(st.momentum), error=np.asarray(st.error),
                client_vel=np.asarray(st.client_vel),
                client_err=np.asarray(st.client_err))


def _split(cfg, batch):
    """fedavg's ``[W, L, B/L, ...]`` layout, as tests/test_round.py's
    ``_run`` gives it to the reference."""
    L = cfg.round_microbatches
    return batch if not L else {
        k: v.reshape((v.shape[0], L, v.shape[1] // L) + v.shape[2:])
        for k, v in batch.items()}


def _port_run(rounds, kw):
    _, params, _, batches = rounds
    sess = FederatedSession(Config(**kw, device="cpu"), to_numpy_tree(params),
                            classification_loss(torch_tinymlp))
    losses = [float(sess.train_round(ids, b, LR)["loss"])
              for ids, b in batches]
    st = sess.state
    out = dict(losses=np.asarray(losses), params=st.params_vec.numpy(),
               decode=sess.sketch_decode_resolved)
    for leaf in ("momentum", "error"):
        if getattr(st, leaf) is not None:
            out[leaf] = getattr(st, leaf).numpy()
    return out


def _assert_twin(got, want, tables=True,
                 leaves=("momentum", "error")):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                               atol=1e-5)
    for leaf in leaves if tables else ():
        if want[leaf].size:  # an absent reference leaf is ()
            np.testing.assert_allclose(
                got[leaf], want[leaf], rtol=0,
                atol=1e-5 * max(np.abs(want[leaf]).max(), 1.0))
        else:
            assert leaf not in got


@pytest.fixture(scope="module")
def gloo_ranks(rounds, tmp_path_factory):
    """Run tests/test_torch_gloo_worker.py as two gloo ranks over every
    two-device job of this module; returns each rank's outputs."""
    tmp = tmp_path_factory.mktemp("gloo")
    _, params, _, batches = rounds
    arrays = {f"{layer}/{leaf}": np.asarray(params["params"][layer][leaf])
              for layer in ("Dense_0", "Dense_1") for leaf in ("kernel",
                                                               "bias")}
    arrays["ids"] = np.stack([ids for ids, _ in batches])
    arrays["x"] = np.stack([b["x"] for _, b in batches])
    arrays["y"] = np.stack([b["y"] for _, b in batches])
    for name, (v, _) in TOPK_VECTORS.items():
        arrays[f"topk/{name}"] = v.astype(np.float32)
    arrays["ties/table"] = _tied_table()[1]
    two = {**BASE, "num_devices": 2}
    cases = {name: {**two, **SHARDED, **case}
             for name, case in DECODE_CASES.items()}
    # sketch_decode='auto' resolves to the sharded decode on two devices
    cases["golden_sketch_threshold"] = {**two,
                                        **GOLDEN_CONFIGS["sketch_threshold"]}
    cases.update({name: {**two, **case}
                  for name, case in CLIENT_STATE_CASES.items()})
    cases.update({name: {**two, **case}
                  for name, case in FEDSIM_CASES.items()})
    cases["sketch_fused_bwd_two_ranks"] = {**two, **FUSED_BWD_TWO_RANKS,
                                           "sketch_fused_bwd": True}
    job = {"lr": LR, "cases": cases,
           "topk": {name: k for name, (_, k) in TOPK_VECTORS.items()},
           "ties": TIES}
    (tmp / "job.json").write_text(json.dumps(job))
    np.savez(tmp / "in.npz", **arrays)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "test_torch_gloo_worker.py"),
         str(rank), "2", str(tmp / "init"), str(tmp / "job.json"),
         str(tmp / "in.npz"), str(tmp / f"out{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp / f"out{rank}.npz")) for rank in range(2)]


def _rank_case(outs, name):
    """Rank 0's outputs for one case, after checking that rank 1 holds the
    same replicated state bit for bit."""
    keys = [k for k in outs[0] if k.startswith(name + "/")]
    for k in keys:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])
    return {k.split("/", 1)[1]: outs[0][k] for k in keys}


# -- sessions ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ONE_DEVICE_CASES))
def test_sharded_decode_twins_one_device(rounds, name):
    kw = {**BASE, "num_devices": 1, **SHARDED, **ONE_DEVICE_CASES[name]}
    with pytest.warns(UserWarning, match="degenerate"):
        want = _ref_run(rounds, kw)
    with pytest.warns(UserWarning, match="degenerate"):
        got = _port_run(rounds, kw)
    assert got["decode"] == "sharded"
    _assert_twin(got, want)


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_sharded_decode_twins_two_gloo_ranks(rounds, gloo_ranks, name):
    want = _ref_run(rounds, {**BASE, "num_devices": 2, **SHARDED,
                             **DECODE_CASES[name]})
    got = _rank_case(gloo_ranks, name)
    assert str(got["decode"]) == "sharded"
    _assert_twin(got, want)


@pytest.mark.parametrize("name", sorted(CLIENT_STATE_CASES))
def test_client_state_modes_two_gloo_ranks(rounds, gloo_ranks, name):
    """Each rank computes its 4 of the 8 clients; the new bank rows of
    both ranks are all-gathered, so the banks (compared bit for bit
    between the ranks by ``_rank_case``) match the reference's
    replicated ones."""
    want = _ref_run(rounds, {**BASE, "num_devices": 2,
                             **CLIENT_STATE_CASES[name]})
    got = _rank_case(gloo_ranks, name)
    _assert_twin(got, want, leaves=("momentum", "error", "client_vel",
                                    "client_err"))
    if name.startswith("local_topk"):
        assert np.abs(got["client_vel"]).max() > 0


@pytest.mark.parametrize("name", sorted(FEDSIM_CASES))
def test_fedsim_masking_two_gloo_ranks(rounds, gloo_ranks, name):
    """The masked rounds on two ranks against the reference's masked run
    on two devices: both draw the same masks from the seed."""
    want = _ref_run(rounds, {**BASE, "num_devices": 2, **FEDSIM_CASES[name]})
    got = _rank_case(gloo_ranks, name)
    _assert_twin(got, want, leaves=("momentum", "error", "client_vel",
                                    "client_err"))


def test_sketch_fused_bwd_two_gloo_ranks(rounds, gloo_ranks):
    """Two ranks of the fused backward against one process's dense-grad
    fused round, at the reference's fused parity bound."""
    got = _rank_case(gloo_ranks, "sketch_fused_bwd_two_ranks")
    want = _port_run(rounds, {**BASE, "num_devices": 1,
                              **FUSED_BWD_TWO_RANKS})
    scale = max(np.abs(want["params"]).max(), 1.0)
    np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                               atol=5e-5 * scale)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


@pytest.mark.parametrize("name", ["sketch", "sketch_threshold"])
def test_port_matches_golden_recording(rounds, name):
    """The recordings were taken on the reference's 8-device mesh; the
    port runs them on one device (``sketch_threshold`` through the
    explicit sharded decode, ``sketch`` through the dense one)."""
    golden = np.load(GOLDEN)
    kw = {**BASE, "num_devices": 1, **GOLDEN_CONFIGS[name]}
    if name == "sketch_threshold":
        kw["sketch_decode"] = "sharded"
        with pytest.warns(UserWarning, match="degenerate"):
            got = _port_run(rounds, kw)
    else:
        got = _port_run(rounds, kw)
    assert got["decode"] == ("sharded" if name == "sketch_threshold"
                             else "dense")
    _assert_twin(got, {"losses": golden[f"{name}__losses"],
                       "params": golden[f"{name}__params"]}, tables=False)


def test_golden_sketch_threshold_on_two_gloo_ranks(gloo_ranks):
    golden = np.load(GOLDEN)
    got = _rank_case(gloo_ranks, "golden_sketch_threshold")
    assert str(got["decode"]) == "sharded"  # auto, two devices, threshold
    _assert_twin(got, {"losses": golden["sketch_threshold__losses"],
                       "params": golden["sketch_threshold__params"]},
                 tables=False)


# -- estimate_at (K4's plain version) ------------------------------------------


def _estimate_case(d, c, r, seed, n, family, dup=False):
    s_ref = ref_cs.CountSketch(d=d, c=c, r=r, seed=seed, hash_family=family)
    s_port = port_cs.CountSketch(d=d, c=c, r=r, seed=seed,
                                 hash_family=family)
    rng = np.random.default_rng(seed)
    table = rng.normal(size=s_ref.table_shape).astype(np.float32)
    idx = rng.choice(d, size=n, replace=False)
    if dup:
        idx[:5] = 0  # repeated pads, as in a gathered candidate buffer
    want = np.asarray(dk.estimate_at_pallas(s_ref, jnp.asarray(table),
                                            jnp.asarray(idx.astype(np.int32))))
    t, i = torch.from_numpy(table), torch.from_numpy(idx.astype(np.int64))
    np.testing.assert_array_equal(estimate_at_torch(s_port, t, i).numpy(),
                                  want)
    np.testing.assert_array_equal(port_cs.estimate_at(s_port, t, i).numpy(),
                                  want)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_estimate_at_matches_pallas_single_block(family):
    spec = ref_cs.CountSketch(d=10_000, c=2_000, r=5, seed=7)
    assert spec.table_shape[0] * spec.table_shape[1] * 4 <= dk.VMEM_TABLE_BYTES
    _estimate_case(10_000, 2_000, 5, 7, 513, family)
    _estimate_case(5_000, 1_024, 5, 3, 700, family, dup=True)


@pytest.mark.parametrize("family", ["fmix32", "poly4"])
def test_estimate_at_matches_pallas_many_blocks(monkeypatch, family):
    monkeypatch.setattr(dk, "VMEM_TABLE_BYTES", 1 << 14)  # CB ~ 768
    spec = ref_cs.CountSketch(d=50_011, c=8_000, r=5, seed=7)
    assert spec.table_shape[0] * spec.table_shape[1] * 4 > dk.VMEM_TABLE_BYTES
    _estimate_case(50_011, 8_000, 5, 7, 1025, family)


def test_estimate_at_all_coordinates_is_estimate_all():
    """K4 at ``arange(d)`` is K2 unscrambled: the plain versions agree bit
    for bit (the card holds the kernels to the same identity)."""
    spec = port_cs.CountSketch(d=20_011, c=4_000, r=3, m=512)
    table = torch.from_numpy(np.random.default_rng(3).normal(
        size=spec.table_shape).astype(np.float32))
    assert torch.equal(port_cs.estimate_at(spec, table,
                                           torch.arange(spec.d)),
                       port_cs.estimate_all(spec, table))


def test_estimate_at_wrapper_refuses_what_it_does_not_take():
    spec = port_cs.CountSketch(d=1_000, c=512, r=3)
    table = torch.zeros(spec.table_shape)
    for bad in ([0, 1000], [-1, 3]):
        with pytest.raises(ValueError, match=r"\[0, 1000\)"):
            estimate_at_kernel(spec, table, torch.tensor(bad))
    with pytest.raises(TypeError, match="int64"):
        estimate_at_kernel(spec, table, torch.tensor([0, 1],
                                                     dtype=torch.int32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        estimate_at_kernel(spec, table.to(torch.float64),
                           torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="shape"):
        estimate_at_kernel(spec, table[:, :-1].contiguous(),
                           torch.tensor([0]))


def test_sketch_sparse_matches_reference():
    s_ref = ref_cs.CountSketch(d=20_011, c=4_000, r=3, m=512, seed=7)
    s_port = port_cs.CountSketch(d=20_011, c=4_000, r=3, m=512, seed=7)
    rng = np.random.default_rng(4)
    idx = rng.choice(20_011, size=600, replace=False)
    idx[:40] = idx[40:80]  # repeats accumulate
    vals = rng.normal(size=600).astype(np.float32)
    want = np.asarray(ref_cs.sketch_sparse(s_ref, jnp.asarray(
        idx.astype(np.uint32)), jnp.asarray(vals)))
    got = port_cs.sketch_sparse(s_port, torch.from_numpy(idx),
                                torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- top-k ---------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TOPK_VECTORS))
def test_topk_threshold_dense_matches_reference(name):
    v, k = TOPK_VECTORS[name]
    v = v.astype(np.float32)
    want = np.asarray(ref_topk.topk_threshold_dense(jnp.asarray(v), k))
    got = port_topk.topk_threshold_dense(torch.from_numpy(v), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) <= k


@pytest.mark.parametrize("name", sorted(TOPK_VECTORS))
def test_topk_threshold_sharded_two_gloo_ranks_matches_reference(gloo_ranks,
                                                                 name):
    v, k = TOPK_VECTORS[name]
    P = jax.sharding.PartitionSpec
    fn = shard_map(lambda x: ref_topk.topk_threshold_sharded(x, k, WORKERS),
                   mesh=make_mesh(2), in_specs=(P(WORKERS),),
                   out_specs=P(WORKERS))
    want = np.asarray(jax.jit(fn)(jnp.asarray(v.astype(np.float32))))
    np.testing.assert_array_equal(gloo_ranks[0][f"topk/{name}"], want)
    np.testing.assert_array_equal(gloo_ranks[1][f"topk/{name}"], want)


def test_compact_nonzero_contract():
    v = torch.zeros(20)
    v[torch.tensor([3, 7, 15])] = torch.tensor([1.5, -2.0, 0.25])
    idx, val = port_topk.compact_nonzero(v, 5)
    assert idx.shape == val.shape == (5,) and idx.dtype == torch.int64
    assert idx.tolist() == [3, 7, 15, 0, 0]
    assert val.tolist() == [1.5, -2.0, 0.25, 0.0, 0.0]
    idx, val = port_topk.compact_nonzero(torch.tensor([0.0, 2.0, 0.0]), 10)
    assert idx.shape == (3,) and float(val[0]) == 2.0
    idx, val = port_topk.compact_nonzero(torch.zeros(8), 4)
    assert not val.any()
    dense = torch.zeros(64)
    dense[torch.arange(0, 64, 8)] = 1.0 + torch.arange(8.0)
    idx, val = port_topk.compact_nonzero(dense, 8)
    assert torch.equal(torch.zeros(64).index_add(0, idx, val), dense)


@pytest.mark.parametrize("nnz,k", [(30, 50), (50, 50), (80, 50), (0, 7)])
def test_compact_nonzero_matches_reference(nnz, k):
    rng = np.random.default_rng(nnz)
    v = np.zeros(1000, np.float32)
    v[rng.choice(1000, size=nnz, replace=False)] = rng.normal(size=nnz)
    want_i, want_v = ref_topk.compact_nonzero(jnp.asarray(v), k)
    got_i, got_v = port_topk.compact_nonzero(torch.from_numpy(v), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _tied_table():
    """tests/test_sketch_decode.py's degenerate case: 64 coordinates tie
    at the max estimate, more than k = 30."""
    spec = ref_cs.CountSketch(d=TIES["d"], c=TIES["c"], r=TIES["r"], seed=0)
    v = jnp.zeros(TIES["d"]).at[jnp.arange(0, TIES["d"], 64)].set(1.0)
    table = np.asarray(ref_cs.sketch_vec(spec, v))
    return spec, table


def test_degenerate_topk_ties_drop_identically(gloo_ranks):
    """Both decodes drop a tied set larger than k (the at-most-k
    contract), at one device and on two gloo ranks."""
    ref_spec, table = _tied_table()
    est = np.asarray(ref_cs.estimate_all(ref_spec, jnp.asarray(table)))
    assert int(np.sum(np.abs(est) >= np.abs(est).max())) > 30
    spec = port_cs.CountSketch(d=TIES["d"], c=TIES["c"], r=TIES["r"], seed=0)
    for decode in ("dense", "sharded"):
        cfg = Config(**{**TIES["config"], "num_devices": 1,
                        "sketch_decode": decode}, device="cpu")
        comp = get_compressor(cfg, d=TIES["d"], spec=spec)
        t = torch.from_numpy(table)
        if decode == "dense":
            delta, _, _, _ = comp.server_update(None, None, None, t, 0.1, 0)
            assert float(delta.abs().max()) == 0.0
        else:
            g_idx, g_val, _, _, _ = comp.server_update_sharded(
                None, None, None, t, 0.1, 0, group=make_worker_group(cfg),
                d=TIES["d"])
            assert g_idx.shape == (30,) and float(g_val.abs().max()) == 0.0
    for out in gloo_ranks:
        assert out["ties/idx"].shape == (2 * 30,)
        assert not out["ties/val"].any()


# -- resolution and refusals ---------------------------------------------------


def test_auto_resolution_and_refusals(rounds):
    _, params, _, _ = rounds
    kw = {**BASE, "num_devices": 1, **SKETCH, "error_type": "virtual",
          "virtual_momentum": 0.9}
    loss = classification_loss(torch_tinymlp)

    def decode(**over):
        cfg = Config(**{**kw, **over}, device="cpu")
        return FederatedSession(cfg, to_numpy_tree(params),
                                loss).sketch_decode_resolved

    assert decode() == "dense"  # one device: auto keeps the dense decode
    assert decode(topk_method="exact") == "dense"
    assert decode(sketch_decode="dense") == "dense"
    with pytest.warns(UserWarning, match="degenerate"):
        assert decode(sketch_decode="sharded") == "sharded"
    with pytest.raises(ValueError, match="threshold"):
        Config(**{**kw, "topk_method": "exact"}, sketch_decode="sharded")
    with pytest.raises(ValueError, match="sketch"):
        Config(**{**BASE, "num_devices": 1}, mode="uncompressed",
               sketch_decode="sharded")
    with pytest.raises(ValueError, match="auto|dense|sharded"):
        Config(**kw, sketch_decode="bogus")
    with pytest.raises(ValueError, match="divisible"):
        Config(**{**kw, "num_devices": 3})
    with pytest.raises(ValueError, match="allow_unstable_sketch_dampening"):
        Config(**kw, momentum_dampening=True)
    # more devices than processes: the group is missing, and the error
    # says how to start one
    with pytest.raises(RuntimeError, match="torchrun"):
        make_worker_group(Config(**{**kw, "num_devices": 2}, device="cpu"))

"""The port's other compressors (true_topk, local_topk, fedavg, powersgd),
its client banks and its fused clients against the reference, on the CPU.

Three kinds of checks, all at tests/test_round.py's TinyMLP size:

* live twins: four rounds of a reference session and a port session from
  the same initial state (the reference's, carried over with
  ``interop.state_from_jax``: params and, for powersgd, the warm-start
  ``Q`` its PRNG drew) and the same batches, one device each. Losses
  ``rtol 1e-4``; params ``atol 1e-5``; every other state leaf (server
  momentum and error, the client banks, ``Q``) ``atol 1e-5 * max|leaf|``
  (tests/test_torch_sharded_decode.py's ``_assert_twin`` bounds: the port
  sums client gradients and matrix products in another fp32 order);
* the golden recordings of tests/golden/registry_parity.npz for these
  modes, at the same tolerances, with the initial params drawn by the
  non-partitionable threefry PRNG the recordings were made with;
* the reference's own oracles (tests/test_round.py, tests/test_powersgd.py)
  rerun through the port, at the reference's tolerances.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.compress import powersgd as ref_powersgd
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.models.losses import IGNORE_INDEX
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.compress import powersgd
from commefficient_tpu_torch.interop import (
    STATE_LEAVES,
    state_from_jax,
    state_to_jax,
)
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.utils.config import Config
from test_compress_parity import GOLDEN, GOLDEN_CONFIGS
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

LR = 0.2
N_ROUNDS = 4
ONE = {**BASE, "num_devices": 1}
D_TINY = 8 * 16 + 16 + 16 * 4 + 4  # TinyMLP's flat size

TWINS = {
    "true_topk_virtual": dict(mode="true_topk", error_type="virtual",
                              virtual_momentum=0.9, k=40),
    "true_topk_no_error": dict(mode="true_topk", error_type="none",
                               virtual_momentum=0.9, k=40),
    "local_topk_local_momentum": dict(mode="local_topk", error_type="local",
                                      local_momentum=0.9, k=30),
    "local_topk_no_error": dict(mode="local_topk", error_type="none", k=30),
    "fedavg_local_lr": dict(mode="fedavg", num_local_iters=2, local_lr=0.1),
    "fedavg_server_lr": dict(mode="fedavg", num_local_iters=2),
    "powersgd_virtual": dict(mode="powersgd", error_type="virtual",
                             powersgd_rank=2, virtual_momentum=0.9),
    "powersgd_no_error": dict(mode="powersgd", error_type="none",
                              powersgd_rank=2, virtual_momentum=0.9),
    "sketch_local_momentum": dict(mode="sketch", error_type="virtual",
                                  virtual_momentum=0.9, local_momentum=0.9,
                                  k=60, num_rows=5, num_cols=512),
    "uncompressed_fused": dict(mode="uncompressed", virtual_momentum=0.9,
                               fuse_clients=True),
}
GOLDEN_NAMES = ("true_topk", "local_topk", "fedavg", "uncompressed_fused",
                "uncompressed_topk_down")


@pytest.fixture(scope="module")
def setup():
    """(dataset, initial params, reference loss) with the params drawn by
    the non-partitionable threefry PRNG, the JAX default when the golden
    recordings were made."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        ds, params, loss_ref = _setup(BASE["num_clients"])
        params = jax.tree.map(np.asarray, params)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return ds, params, loss_ref


def _rounds(ds, cfg, sample_batch):
    """N_ROUNDS (client ids, batch) draws of the reference's sampler (seed
    1, as tests/test_round.py's ``_run``), ``sample_batch`` samples a
    client, in the ``[W, L, b, ...]`` layout for fedavg."""
    sampler = RefSampler(ds, num_workers=cfg.num_workers,
                         local_batch_size=sample_batch, seed=1)
    out = []
    for r in range(N_ROUNDS):
        ids, batch = sampler.sample_round(r)
        out.append((ids, microbatched(cfg, batch)))
    return out


def _port_session(cfg_kw, params, ref_state=None):
    sess = FederatedSession(Config(**cfg_kw, device="cpu"),
                            to_numpy_tree(params),
                            classification_loss(torch_tinymlp))
    if ref_state is not None:
        sess.state = state_from_jax(_leaves(ref_state))
    return sess


def _leaves(ref_state):
    return {name: np.asarray(getattr(ref_state, name))
            for name in STATE_LEAVES}


def _twin(setup, kw):
    """(reference result, port result) of N_ROUNDS rounds from the
    reference's initial state: ``losses`` and every state leaf."""
    ds, params, loss_ref = setup
    ref = RefSession(RefConfig(**kw), params, loss_ref)
    port = _port_session(kw, params, ref.state)
    assert port.bytes_per_round() == ref.bytes_per_round()
    cfg = port.cfg
    rounds = _rounds(ds, cfg, cfg.sampler_batch_size)
    want = {"losses": [float(ref.train_round(i, b, LR)["loss"])
                       for i, b in rounds]}
    got = {"losses": [float(port.train_round(i, b, LR)["loss"])
                      for i, b in rounds]}
    want.update(_leaves(ref.state))
    got.update(state_to_jax(port.state))
    return want, got


def _assert_state_twin(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for name in STATE_LEAVES:
        w = np.asarray(want[name])
        if name == "step":
            assert int(got[name]) == int(w)
        elif name == "params_vec":
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5)
        elif w.size == 0:  # absent in the reference: absent in the port
            assert got[name] == (), name
        else:
            np.testing.assert_allclose(
                got[name], w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0),
                err_msg=name)


@pytest.mark.parametrize("case", sorted(TWINS))
def test_four_round_twins_match_reference(setup, case):
    kw = {**ONE, **TWINS[case]}
    auto_warns = kw["mode"] == "true_topk"  # AUTO dampening, momentum on
    with (pytest.warns(UserWarning, match="momentum_dampening=AUTO")
          if auto_warns else contextlib.nullcontext()):
        want, got = _twin(setup, kw)
    _assert_state_twin(got, want)
    if kw.get("local_momentum") or kw.get("error_type") == "local":
        assert any(np.abs(got[b]).max() > 0 for b in ("client_vel",
                                                       "client_err")
                   if np.size(got[b]))


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_port_matches_golden_recording(setup, name):
    """The recordings were taken on the reference's 8-device mesh with
    tests/test_round.py's ``_run`` (its sampler draws ``local_batch_size``
    samples a client, reshaped for fedavg); the port runs them on one
    device."""
    ds, params, _ = setup
    golden = np.load(GOLDEN)
    kw = {**ONE, **GOLDEN_CONFIGS[name]}
    port = _port_session(kw, params)
    losses = [float(port.train_round(i, b, LR)["loss"])
              for i, b in _rounds(ds, port.cfg, kw["local_batch_size"])]
    np.testing.assert_allclose(losses, golden[f"{name}__losses"], rtol=1e-4)
    np.testing.assert_allclose(port.state.params_vec.numpy(),
                               golden[f"{name}__params"], rtol=0, atol=1e-5)


# -- the reference's oracles, rerun through the port ---------------------------


def _port_run(setup, kw, n_rounds=5, lr=0.3, sample_batch=None):
    """tests/test_round.py's ``_run`` on the port: rounds of the seed-1
    sampler at ``lr``; returns the session and the losses."""
    ds, params, _ = setup
    sess = _port_session({**ONE, **kw}, params)
    sampler = RefSampler(ds, num_workers=sess.cfg.num_workers,
                         local_batch_size=sample_batch
                         or sess.cfg.local_batch_size, seed=1)
    losses = []
    for r in range(n_rounds):
        ids, batch = sampler.sample_round(r)
        losses.append(float(sess.train_round(
            ids, microbatched(sess.cfg, batch), lr)["loss"]))
    return sess, losses


def _final(sess):
    return sess.state.params_vec.numpy()


@pytest.mark.parametrize("kw", [
    dict(mode="true_topk", error_type="virtual"),
    dict(mode="local_topk", error_type="local"),
    dict(mode="local_topk", error_type="none"),
], ids=["true_topk", "local_topk_local", "local_topk_none"])
def test_full_k_equals_uncompressed(setup, kw):
    st, _ = _port_run(setup, {**kw, "k": D_TINY})
    su, _ = _port_run(setup, dict(mode="uncompressed"))
    np.testing.assert_allclose(_final(st), _final(su), atol=1e-5)


def test_fedavg_one_iter_equals_uncompressed(setup):
    sf, _ = _port_run(setup, dict(mode="fedavg", num_local_iters=1,
                                  local_lr=0.1))
    su, _ = _port_run(setup, dict(mode="uncompressed"))
    np.testing.assert_allclose(_final(sf), _final(su), atol=1e-5)


@pytest.mark.parametrize("mode,extra", [
    ("uncompressed", {}),
    ("sketch", dict(error_type="virtual", virtual_momentum=0.9, k=60,
                    num_rows=5, num_cols=512)),
    ("true_topk", dict(error_type="virtual", virtual_momentum=0.9, k=40)),
    ("powersgd", dict(error_type="virtual", powersgd_rank=2)),
])
def test_fuse_clients_matches_per_client_path(setup, mode, extra):
    kw = dict(mode=mode, **extra)
    sa, la = _port_run(setup, kw)
    sb, lb = _port_run(setup, {**kw, "fuse_clients": True})
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    np.testing.assert_allclose(_final(sa), _final(sb), atol=2e-5)


def test_fused_gate_is_the_references(setup):
    """The flattened batch only where nothing is per client: every
    blocker of the reference's gate falls back to the per-client loop."""
    from commefficient_tpu_torch.compress import get_compressor
    from commefficient_tpu_torch.parallel.round import fused_clients

    def gate(**kw):
        cfg = Config(**{**ONE, "fuse_clients": True, **kw}, device="cpu")
        return fused_clients(cfg, get_compressor(cfg, d=D_TINY))

    assert gate(mode="uncompressed") and gate(mode="true_topk")
    assert gate(mode="powersgd")
    assert not gate(mode="uncompressed", fuse_clients=False)
    assert not gate(mode="fedavg") and not gate(mode="local_topk")
    assert not gate(mode="uncompressed", local_momentum=0.9)
    assert not gate(mode="uncompressed", max_grad_norm=1.0)


def test_client_rows_change_only_for_participants(setup):
    ds, params, _ = setup
    sess = _port_session({**ONE, "mode": "local_topk", "error_type": "local",
                          "k": 20, "local_momentum": 0.9}, params)
    ids, batch = RefSampler(ds, num_workers=8, local_batch_size=4,
                            seed=1).sample_round(0)
    sess.train_round(ids, batch, 0.1)
    part = np.zeros(BASE["num_clients"], bool)
    part[ids] = True
    for bank in (sess.state.client_vel.numpy(), sess.state.client_err.numpy()):
        assert np.abs(bank[part]).sum() > 0
        assert np.abs(bank[~part]).sum() == 0
    with pytest.raises(ValueError, match="client_ids"):
        sess.train_round(None, batch, 0.1)
    with pytest.raises(ValueError, match=r"\[0, 12\)"):
        sess.train_round(np.arange(4, 12) + 4, batch, 0.1)


def _ignore_labels(batch):
    return {**batch, "y": np.full_like(batch["y"], IGNORE_INDEX)}


@pytest.mark.parametrize("kw", [
    dict(mode="true_topk", error_type="virtual", k=5),
    dict(mode="sketch", error_type="virtual", k=5, num_rows=5, num_cols=512),
    dict(mode="local_topk", error_type="local", k=5),
    dict(mode="powersgd", error_type="virtual", powersgd_rank=2),
], ids=["true_topk", "sketch", "local_topk", "powersgd"])
def test_error_feedback_banks_lr_at_accumulation(setup, kw):
    """Round 2 has zero gradient (every label ignored), so what it applies
    is the residual banked in round 1; round 2's lr must not rescale it."""
    ds, params, _ = setup
    ids, batch = RefSampler(ds, num_workers=8, local_batch_size=4,
                            seed=1).sample_round(0)
    finals = []
    for lr2 in (0.01, 1.0):
        sess = _port_session({**ONE, **kw}, params)
        sess.train_round(ids, batch, 0.3)
        sess.train_round(ids, _ignore_labels(batch), lr2)
        finals.append(_final(sess))
    np.testing.assert_allclose(finals[0], finals[1], atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(error_type="virtual", virtual_momentum=0.0),
    dict(error_type="virtual", virtual_momentum=0.9),
    dict(error_type="none", virtual_momentum=0.9),
], ids=["virtual", "virtual_momentum", "no_error_momentum"])
def test_powersgd_full_rank_equals_uncompressed(setup, kw):
    """At r = min(n, m) the power iteration reconstructs exactly, for any
    Q (the port's own draw here); tests/test_powersgd.py's tolerances."""
    n, m = powersgd.matrix_shape(D_TINY)
    sp, lp = _port_run(setup, dict(mode="powersgd", powersgd_rank=min(n, m),
                                   **kw))
    su, lu = _port_run(setup, dict(mode="uncompressed",
                                   virtual_momentum=kw["virtual_momentum"]))
    np.testing.assert_allclose(lp, lu, rtol=1e-4)
    np.testing.assert_allclose(_final(sp), _final(su), atol=5e-4)


def test_gram_schmidt_orthonormalizes_and_matches_reference():
    rng = np.random.default_rng(0)
    P = rng.normal(size=(40, 6)).astype(np.float32)
    Q = powersgd.gram_schmidt(torch.from_numpy(P)).numpy()
    np.testing.assert_allclose(Q.T @ Q, np.eye(6), atol=1e-5)
    np.testing.assert_allclose(Q @ (Q.T @ P), P, atol=1e-4)
    want = np.asarray(ref_powersgd.gram_schmidt(jnp.asarray(P)))
    np.testing.assert_allclose(Q, want, rtol=0, atol=1e-5)


def test_gram_schmidt_rank_deficient_collapses_to_zero():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 1)).astype(np.float32)
    P = np.concatenate([a, 2.0 * a, a + 1e-9], axis=1)
    Q = powersgd.gram_schmidt(torch.from_numpy(P)).numpy()
    assert np.abs(Q[:, 1]).max() < 1e-5
    np.testing.assert_allclose(np.linalg.norm(Q[:, 0]), 1.0, atol=1e-5)
    want = np.asarray(ref_powersgd.gram_schmidt(jnp.asarray(P)))
    np.testing.assert_array_equal(Q[:, 1:] == 0, want[:, 1:] == 0)


def test_powersgd_geometry_and_q_draws():
    """The matricization is the reference's; at ResNet-9's D the downlink
    is 4 * (2564 + 2564) = 20,512 floats; Q is drawn from the seed (the
    same on every call, another for another step or seed), and without
    warm start no Q is carried."""
    for d in (1, 2, 212, 1000, 6_573_130, 10**7 + 3):
        assert powersgd.matrix_shape(d) == ref_powersgd.matrix_shape(d)
    cfg = Config(mode="powersgd", device="cpu")
    comp = powersgd.PowerSGDCompressor(cfg, 6_573_130)
    assert (comp.n, comp.m, comp.rank) == (2564, 2564, 4)
    assert comp.download_floats() == 20_512
    small = powersgd.PowerSGDCompressor(cfg, D_TINY)
    q = small.init_extra_state("cpu")
    assert q.shape == (15, 4) and q.dtype == torch.float32
    assert torch.equal(q, small.init_extra_state("cpu"))
    assert not torch.equal(small._fresh_q(1, "cpu"), small._fresh_q(2, "cpu"))
    other = powersgd.PowerSGDCompressor(cfg.replace(seed=7), D_TINY)
    assert not torch.equal(q, other.init_extra_state("cpu"))
    assert powersgd.POWERSGD_Q_STREAM == ref_powersgd.POWERSGD_Q_STREAM
    cold = powersgd.PowerSGDCompressor(cfg.replace(powersgd_warm_start=False),
                                       D_TINY)
    assert cold.init_extra_state("cpu") is None


def test_powersgd_without_warm_start_carries_no_q(setup):
    sess, losses = _port_run(setup, dict(mode="powersgd",
                                         error_type="virtual",
                                         powersgd_rank=1,
                                         powersgd_warm_start=False),
                             n_rounds=2)
    assert sess.state.comp is None and np.isfinite(losses).all()
    warm, _ = _port_run(setup, dict(mode="powersgd", error_type="virtual",
                                    powersgd_rank=3), n_rounds=1)
    assert warm.state.comp.shape == (15, 3)


def test_fedavg_at_zero_lr_is_finite(setup):
    """The schedule's last round has lr = 0: with local_lr None the local
    steps take no step and the delta is 0, not 0/0."""
    ds, params, _ = setup
    sess = _port_session({**ONE, "mode": "fedavg", "num_local_iters": 2},
                         params)
    ids, batch = RefSampler(ds, num_workers=8, local_batch_size=8,
                            seed=1).sample_round(0)
    before = _final(sess).copy()
    m = sess.train_round(ids, microbatched(sess.cfg, batch), 0.0)
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(_final(sess), before, atol=1e-7)


def test_bytes_per_round_per_mode(setup):
    _, params, _ = setup

    def bpr(**kw):
        return _port_session({**ONE, **kw}, params).bytes_per_round()

    assert bpr(mode="local_topk", error_type="local", k=30) == {
        "upload_floats": 60, "download_floats": D_TINY,
        "upload_bytes": 240, "download_bytes": 4 * D_TINY}
    n, m = powersgd.matrix_shape(D_TINY)
    assert bpr(mode="powersgd", powersgd_rank=2)["download_floats"] == \
        2 * (n + m)
    for mode in ("true_topk", "fedavg"):
        assert bpr(mode=mode)["upload_floats"] == D_TINY
    assert bpr(mode="uncompressed", do_topk_down=True, k=25)[
        "download_floats"] == 50


def test_config_follows_reference_for_the_new_modes():
    for kw in (dict(mode="fedavg", num_local_iters=3, local_batch_size=4),
               dict(mode="local_topk", error_type="local"),
               dict(mode="powersgd", powersgd_rank=3)):
        port, ref = Config(**kw, device="cpu"), RefConfig(**kw)
        assert port.sampler_batch_size == ref.sampler_batch_size
        assert port.round_microbatches == ref.round_microbatches
    for bad, match in ((dict(do_topk_down=True), "do_topk_down"),
                       (dict(momentum_dampening=True), "dampening"),
                       (dict(powersgd_rank=0), "powersgd_rank")):
        for cls in (Config, RefConfig):
            with pytest.raises(ValueError, match=match):
                cls(mode="powersgd", **bad)
    with pytest.raises(ValueError, match="client_store"):
        Config(client_store="disk")
    with pytest.raises(NotImplementedError):
        FederatedSession(Config(**ONE, mode="powersgd", error_type="local",
                                device="cpu"),
                         {"w": np.zeros(3, np.float32)},
                         classification_loss(torch_tinymlp))


def test_state_round_trips_through_interop():
    rng = np.random.default_rng(2)
    leaves = {"params_vec": rng.normal(size=7).astype(np.float32),
              "momentum": rng.normal(size=7).astype(np.float32),
              "error": np.asarray(()),
              "client_vel": rng.normal(size=(3, 7)).astype(np.float32),
              "client_err": (), "step": np.int32(5),
              "comp": rng.normal(size=(3, 2)).astype(np.float32)}
    st = state_from_jax(leaves)
    assert st.error is None and st.client_err is None and st.step == 5
    back = state_to_jax(st)
    for name in STATE_LEAVES:
        if np.size(leaves[name]) == 0:
            assert back[name] == ()
        else:
            np.testing.assert_array_equal(back[name], leaves[name])


# -- bf16 tables (tests/test_countsketch_bf16.py's session cases) ---------------

BF16 = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9, k=40,
            num_rows=3, num_cols=256, topk_method="threshold",
            sketch_table_dtype="bfloat16")


@pytest.mark.parametrize("operand", ["float32", "bfloat16"])
def test_bf16_tables_twin_matches_reference(setup, operand):
    """Four rounds with bf16 tables (and bf16 operands) against the
    reference: the same bytes (2 per upload float), bf16 state tables,
    losses ``rtol 1e-4``, params ``atol 1e-5`` and the tables ``atol
    2^-7 * max|table|``, two bf16 ulps at the largest entry
    (tests/test_torch_gpt2.py gives the reason)."""
    kw = {**ONE, **BF16, "sketch_dtype": operand}
    ref_b = RefSession(RefConfig(**{**kw, "sketch_table_dtype": "float32"}),
                       setup[1], setup[2]).bytes_per_round()
    want, got = _twin(setup, kw)
    assert got["momentum"].dtype == np.float32  # state_to_jax widens
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["params_vec"], want["params_vec"],
                               rtol=0, atol=1e-5)
    for name in ("momentum", "error"):
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=2.0**-7 * np.abs(w).max())
    sess = _port_session(kw, setup[1])
    assert sess.state.momentum.dtype == sess.state.error.dtype == \
        torch.bfloat16
    assert sess.compressor.upload_bytes_per_float() == 2
    b16 = sess.bytes_per_round()
    assert b16["upload_floats"] == ref_b["upload_floats"]
    assert 2 * b16["upload_bytes"] == ref_b["upload_bytes"]


def test_bf16_sharded_decode_matches_dense_decode(setup):
    """The sharded decode under bf16 tables against the dense decode under
    the same tables (the reference's test and its bound, ``5e-3 *
    max|params|``: both pay the same storage rounding; only where a bf16
    boundary meets the k-sparse extraction can they part)."""

    def run(decode):
        with contextlib.ExitStack() as stack:
            if decode == "sharded":
                stack.enter_context(pytest.warns(UserWarning,
                                                 match="degenerate"))
            sess, _ = _port_run(setup, {**BF16, "sketch_decode": decode},
                                n_rounds=3, lr=0.2)
        return _final(sess)

    p_dense, p_shard = run("dense"), run("sharded")
    scale = max(np.abs(p_dense).max(), 1.0)
    np.testing.assert_allclose(p_shard, p_dense, rtol=0, atol=5e-3 * scale)

"""The port's host-resident client state (``commefficient_tpu_torch/
clientstore/``) against the reference's, on the CPU, at TinyMLP size.

* the store contract for ``host``, ``mmap`` and ``device`` (the round
  trip, a repeated id's last row winning, an mmap bank persisting across
  reopen, the anonymous file unlinked), the registry equal to
  ``CLIENT_STORES`` and to the reference's, the LRU cache's write-through
  and ``invalidate``, the streamer's staleness, fence, load invalidation
  and writeback fault; ``Config``'s refusals as the reference's and the
  deprecated alias with its warning;
* the sessions: the reference's ``KW`` (local_topk, local error, local
  momentum 0.9: both banks) and the slice's sketch with local momentum
  (one bank; the plain K1 and K2), each 5 rounds: the port's ``host``,
  ``mmap``, cached (4 rows) and ``device`` runs BIT-EQUAL to each other in
  losses, every ``FedState`` leaf and the banks (the hosted round runs the
  same eager ops on the same row values as the device round), and the
  port's hosted run against the REFERENCE's hosted run from its initial
  params (losses ``rtol 1e-4``, params ``atol 1e-5``, banks ``atol 1e-5 *
  max|bank|``: the port sums client gradients in another fp32 order); both
  single-bank modes; the ``clientstore/*`` scalars;
* the pipeline at depth 2 bit-equal to depth 0 on 16 clients, where the
  cohorts collide inside the window and the staged rows are gathered
  again (counted); a kill and resume, a ``retry`` rollback through the
  runner and a ladder rung switch, each bit-equal to its device twin;
  a fedsim round where every client drops, which leaves the banks as they
  were; two gloo ranks hosted against device, bit-equal, each rank with
  its own mmap files; a million clients under an ``RLIMIT_DATA`` the
  device banks do not fit under, where ``mmap`` trains;
* C.4: after ``prepare_plans`` of every rung of a 4-rung ``num_cols``
  ladder, under the sharded decode and at ``num_blocks`` 4, the rounds
  and the switches look up only range plans already built.
"""

import os
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest
import torch

from commefficient_tpu.clientstore import available_stores as ref_available
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.clientstore import (
    CohortStreamer,
    HostStore,
    LRURowCache,
    available_stores,
    build_store,
    register,
)
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops.cuda import countsketch as kern
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer
from commefficient_tpu_torch.utils.config import CLIENT_STORES, Config
from test_round import BASE, _setup
from test_torch_fedsim import _env
from test_torch_gloo_worker import spawn
from test_torch_model import to_numpy_tree, torch_tinymlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = {**BASE, "num_devices": 1}
LR = 0.3
ROUNDS = 5
# the reference's anchor: both client banks live
KW = dict(mode="local_topk", error_type="local", local_momentum=0.9, k=30)
# the slice's path: FetchSGD with local momentum (the velocity bank)
SKETCH_LM = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                 local_momentum=0.9, k=60, num_rows=5, num_cols=512)
CONFIGS = {"local_topk": KW, "sketch_local_momentum": SKETCH_LM}
STORES = {"device": {}, "host": dict(client_store="host"),
          "mmap": dict(client_store="mmap"),
          "cached": dict(client_store="host", client_store_cache_rows=4)}
SCALARS = {"clientstore/cache_hit_rate", "clientstore/evictions",
           "clientstore/h2d_stage_ms", "clientstore/writeback_ms"}


@pytest.fixture(scope="module")
def data():
    """(the reference's dataset, its initial params as numpy, its loss)."""
    ds, params, loss_ref = _setup(BASE["num_clients"])
    return ds, to_numpy_tree(params), loss_ref


def _session(params, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return FederatedSession(Config(**{**ONE, **kw, "device": "cpu"}),
                                params, classification_loss(torch_tinymlp))


def _draws(ds, cfg, rounds=ROUNDS):
    sampler = RefSampler(ds, num_workers=cfg.num_workers,
                         local_batch_size=cfg.local_batch_size, seed=1)
    return [sampler.sample_round(r) for r in range(rounds)]


def _leaves(sess):
    st = sess.state
    return {f: getattr(st, f) for f in ("params_vec", "momentum", "error",
                                        "client_vel", "client_err", "comp")}


def _banks(sess):
    """(vel, err) as numpy: the hosted banks or the FedState's."""
    out = []
    for host, leaf in (("host_vel", "client_vel"), ("host_err",
                                                    "client_err")):
        bank = getattr(sess, host)
        if bank is None and getattr(sess.state, leaf) is not None:
            bank = getattr(sess.state, leaf).numpy()
        out.append(None if bank is None else np.array(bank))
    return tuple(out)


def _port_run(data, kw, draws, lr=LR, env=None):
    sess = _session(data[1], **kw)
    metrics = [sess.train_round(ids, b, lr, env=env) for ids, b in draws]
    out = dict(losses=[float(m["loss"]) for m in metrics], metrics=metrics,
               params=sess.state.params_vec.numpy().copy(),
               banks=_banks(sess), leaves=_leaves(sess),
               hosted=sess._streamer is not None)
    sess.close_client_store()
    return out


def _assert_bit_equal(a, b, what):
    assert a["losses"] == b["losses"], what
    np.testing.assert_array_equal(a["params"], b["params"], err_msg=what)
    for x, y in zip(a["banks"], b["banks"]):
        assert (x is None) == (y is None), what
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=what)
    for leaf in ("momentum", "error", "comp"):
        x, y = a["leaves"][leaf], b["leaves"][leaf]
        assert (x is None) == (y is None), (what, leaf)
        if x is not None:
            assert torch.equal(x, y), (what, leaf)


# -- the store contract ----------------------------------------------------------


def test_registry_mirrors_config_client_stores_and_the_reference():
    assert available_stores() == tuple(sorted(CLIENT_STORES))
    assert available_stores() == ref_available()


def test_register_duplicate_and_unknown_kind_rejected():
    with pytest.raises(ValueError, match="duplicate client store"):
        register("host")(HostStore)
    with pytest.raises(ValueError, match="unknown client store"):
        build_store("bogus", num_rows=4, row_dim=2)


@pytest.mark.parametrize("kind", ["host", "mmap", "device"])
def test_gather_scatter_roundtrip(kind, tmp_path):
    path = str(tmp_path / "bank.vel") if kind == "mmap" else ""
    store = build_store(kind, num_rows=6, row_dim=3, path=path)
    rows = np.arange(6, dtype=np.float32).reshape(2, 3)
    store.scatter_rows(np.array([1, 4]), rows)
    got = store.gather_rows(np.array([4, 1]))
    np.testing.assert_array_equal(got, rows[::-1])
    got[...] = -1.0  # a copy: the bank does not move
    out = np.full((2, 3), 9.0, np.float32)
    assert store.gather_rows(np.array([4, 1]), out=out) is out
    np.testing.assert_array_equal(out, rows[::-1])
    full = np.asarray(store.array())
    np.testing.assert_array_equal(full[[1, 4]], rows)
    assert not full[[0, 2, 3, 5]].any()  # untouched rows stay zero
    # a repeated id: its last row wins, as numpy's fancy assignment
    store.scatter_rows(np.array([2, 5, 2]),
                       np.array([[1, 1, 1], [2, 2, 2], [3, 3, 3]],
                                np.float32))
    np.testing.assert_array_equal(store.gather_rows([2, 5]),
                                  [[3, 3, 3], [2, 2, 2]])
    bank = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    store.load(bank)
    np.testing.assert_array_equal(np.asarray(store.array()), bank)
    with pytest.raises(ValueError, match="bank shape mismatch"):
        store.load(bank[:5])
    store.close()


def test_mmap_persists_across_reopen_and_anonymous_bank_is_unlinked(
        tmp_path):
    path = str(tmp_path / "bank.err")
    store = build_store("mmap", num_rows=5, row_dim=4, path=path)
    rows = np.full((2, 4), 7.0, np.float32)
    store.scatter_rows(np.array([0, 3]), rows)
    store.flush()
    store.close()
    assert os.path.exists(path)  # a named bank survives close
    again = build_store("mmap", num_rows=5, row_dim=4, path=path)
    np.testing.assert_array_equal(again.gather_rows(np.array([0, 3])), rows)
    again.close()
    other = build_store("mmap", num_rows=6, row_dim=4, path=path)
    assert not other.array().any()  # another size: created anew
    other.close()
    anon = build_store("mmap", num_rows=3, row_dim=2)
    assert os.path.exists(anon.path)
    anon.close()
    assert not os.path.exists(anon.path)


def test_lru_eviction_write_through_and_invalidate():
    written = {}
    cache = LRURowCache(2, written.__setitem__)
    cache.put(10, "a")
    cache.put(11, "b")
    assert cache.get(10) == "a" and cache.hits == 1
    assert cache.get(99) is None and cache.misses == 1
    cache.put(12, "c")  # capacity 2: the least recently used (11) goes
    assert cache.evictions == 1 and written == {11: "b"}
    assert 11 not in cache and 10 in cache and 12 in cache
    cache.flush()  # the dirty rows write through and stay, clean
    assert written == {11: "b", 10: "a", 12: "c"}
    written.clear()
    cache.flush()
    assert written == {}
    cache.put(13, "d", dirty=False)  # evicts 10, clean: no writeback
    assert written == {}
    cache.invalidate()  # dropped WITHOUT writeback (a restore)
    assert len(cache) == 0 and written == {}


# -- the streamer -------------------------------------------------------------


def test_streamer_staleness_and_writeback_fence():
    s = CohortStreamer(vel_store=HostStore(num_rows=8, row_dim=2),
                       err_store=HostStore(num_rows=8, row_dim=2),
                       num_clients=8)
    cohort = s.gather(np.array([1, 2]))
    assert not s.is_stale(np.array([1, 2]), cohort.version)
    new = torch.ones(2, 2)
    s.scatter(np.array([2, 5]), new, 2 * new)
    # client 2 written since: stale; a disjoint cohort stays fresh
    assert s.is_stale(np.array([1, 2]), cohort.version)
    assert not s.is_stale(np.array([1, 3]), cohort.version)
    assert s.regathers == 1
    # a gather waits for the pending writeback of its ids
    fresh = s.gather(np.array([2, 5]))
    np.testing.assert_array_equal(fresh.vel, new)
    np.testing.assert_array_equal(fresh.err, 2 * new)
    s.flush()
    np.testing.assert_array_equal(s.vel_array()[[2, 5]], new)
    assert set(s.pop_round_stats()) == SCALARS
    s.close()
    s.close()  # idempotent


def test_streamer_load_invalidates_staged_and_cached_rows():
    s = CohortStreamer(vel_store=HostStore(num_rows=4, row_dim=2),
                       num_clients=4, cache_rows=2)
    cohort = s.gather(np.array([0, 1]))
    s.scatter(np.array([0]), torch.full((1, 2), 5.0), ())
    # a cached row is spliced in at its position
    staged = s.gather(np.array([3, 0]))
    vel, err = s.splice(staged)
    np.testing.assert_array_equal(vel, [[0, 0], [5, 5]])
    assert err == ()  # the absent bank's convention
    bank = np.full((4, 2), 3.0, np.float32)
    s.load_vel(bank)  # a restore: the cached row must not come back
    assert s.is_stale(np.array([0, 1]), cohort.version)
    vel, _ = s.splice(s.gather(np.array([0, 2])))
    np.testing.assert_array_equal(vel, bank[[0, 2]])
    s.flush()
    np.testing.assert_array_equal(s.vel_array(), bank)
    s.close()


def test_streamer_writeback_fault_fails_the_run():
    class Broken(HostStore):
        def scatter_rows(self, ids, rows):
            raise OSError("disk full")

    s = CohortStreamer(vel_store=Broken(num_rows=4, row_dim=2),
                       num_clients=4)
    s.scatter(np.array([1]), torch.ones(1, 2), None)
    with pytest.raises(RuntimeError, match="writeback worker died"):
        s.flush()
    s.scatter(np.array([2]), torch.ones(1, 2), None)
    for e in list(s._pending):  # the worker has failed once this returns
        e.done.wait()
    with pytest.raises(RuntimeError, match="writeback worker died"):
        s.gather(np.array([3]))
    s.close()


# -- Config -------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(client_store="floppy"), "client_store"),
    (dict(client_store_cache_rows=4), "client_store"),
    (dict(client_store="host", client_store_cache_rows=-1), ">= 0"),
    (dict(client_store="host", client_store_path="bank"), "mmap"),
    (dict(client_store_path="bank"), "mmap"),
    (dict(client_store="mmap", fsdp=True, mode="true_topk",
          error_type="virtual", topk_method="threshold"), "fsdp"),
])
def test_config_refuses_what_the_reference_refuses(kw, match):
    with pytest.raises(ValueError, match=match) as port:
        Config(**kw)
    with pytest.raises(ValueError, match=match) as ref:
        RefConfig(**kw)
    assert str(port.value)[:48] == str(ref.value)[:48]


def test_offload_alias_maps_to_host_store_with_a_warning():
    with pytest.warns(DeprecationWarning, match="client_store"):
        cfg = Config(**KW, **BASE, offload_client_state=True)
    assert cfg.client_store == "host" and cfg.client_state_hosted
    mm = Config(client_store="mmap", client_store_path="b",
                client_store_cache_rows=2)
    assert mm.client_state_hosted and not Config().client_state_hosted


def test_host_vel_setter_requires_hosted_store(data):
    sess = _session(data[1], **KW)  # the device store: no streamer
    assert sess._streamer is None and sess.host_vel is None
    with pytest.raises(ValueError, match="no hosted client store"):
        sess.host_vel = np.zeros((12, sess.grad_size), np.float32)
    # a hosted store without a bank to host builds nothing either
    assert _session(data[1], mode="uncompressed",
                    client_store="host")._streamer is None


def test_hosted_store_refuses_device_data(data):
    sess = _session(data[1], **KW, client_store="host")
    with pytest.raises(NotImplementedError, match="contradictory"):
        sess.attach_data({"x": np.zeros((4, 8), np.float32)})
    sess.close_client_store()


# -- the sessions -------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def parity(request, data, tmp_path_factory):
    """Each store's port run of a config (level 1), and the reference's
    hosted run from the same initial params."""
    name = request.param
    kw = {**CONFIGS[name], "telemetry_level": 1}
    ds, params, _ = data
    draws = _draws(ds, Config(**ONE))
    tmp = tmp_path_factory.mktemp(f"clientstore_{name}")
    runs = {}
    for store, over in STORES.items():
        if store == "mmap":
            over = {**over, "client_store_path": str(tmp / "bank")}
        runs[store] = _port_run(data, {**kw, **over}, draws)
    ref = RefSession(RefConfig(**{**ONE, **CONFIGS[name],
                                  "client_store": "host"}),
                     params, data[2])
    losses = [float(ref.train_round(ids, b, LR)["loss"]) for ids, b in draws]
    runs["reference"] = dict(
        losses=losses, params=np.asarray(ref.state.params_vec),
        banks=tuple(None if b is None else np.array(b)
                    for b in (ref.host_vel, ref.host_err)))
    ref.close_client_store()
    runs["name"] = name
    return runs


def test_hosted_runs_bit_equal_to_the_device_banks(parity):
    for store in ("host", "mmap", "cached"):
        _assert_bit_equal(parity[store], parity["device"],
                          f"{parity['name']}:{store}")
        assert parity[store]["hosted"]
    assert not parity["device"]["hosted"]
    vel = parity["host"]["banks"][0]
    assert np.abs(vel).sum() > 0  # momentum flowed


def test_hosted_run_matches_the_reference_hosted_run(parity):
    got, want = parity["host"], parity["reference"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-5)
    for g, w in zip(got["banks"], want["banks"]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_hosted_state_holds_no_client_bank(parity):
    leaves = parity["host"]["leaves"]
    assert leaves["client_vel"] is None and leaves["client_err"] is None
    assert parity["device"]["leaves"]["client_vel"] is not None


def test_clientstore_scalars_ride_the_metrics(parity):
    for m in parity["cached"]["metrics"]:  # the same keys every round
        assert SCALARS <= set(m)
        assert 0.0 <= m["clientstore/cache_hit_rate"] <= 1.0
        assert m["clientstore/h2d_stage_ms"] >= 0.0
        assert m["clientstore/writeback_ms"] >= 0.0
    # a cache of 4 rows under an 8-client cohort evicts
    assert sum(m["clientstore/evictions"]
               for m in parity["cached"]["metrics"]) > 0
    assert any(m["clientstore/cache_hit_rate"] > 0
               for m in parity["cached"]["metrics"])
    for m in parity["device"]["metrics"]:
        assert not SCALARS & set(m)


def test_clientstore_scalars_absent_at_level_zero(data):
    draws = _draws(data[0], Config(**ONE), rounds=1)
    run = _port_run(data, {**KW, "client_store": "host"}, draws)
    assert not any(k.startswith("clientstore/") for k in run["metrics"][0])


@pytest.mark.parametrize("extra", [
    dict(error_type="local", local_momentum=0.0),  # the error bank only
    dict(error_type="none", local_momentum=0.9),  # the velocity bank only
])
def test_single_bank_modes_bit_equal_to_device(data, extra):
    draws = _draws(data[0], Config(**ONE), rounds=4)
    dev = _port_run(data, {**KW, **extra}, draws)
    host = _port_run(data, {**KW, **extra, "client_store": "host"}, draws)
    _assert_bit_equal(host, dev, str(extra))
    assert (host["banks"][0] is None) == (extra["local_momentum"] == 0.0)
    assert (host["banks"][1] is None) == (extra["error_type"] == "none")


def test_all_dropped_round_leaves_the_banks_unchanged(data):
    kw = {**KW, "client_store": "host", "availability": "bernoulli",
          "dropout_prob": 0.5}
    sess = _session(data[1], **kw)
    draws = _draws(data[0], sess.cfg, rounds=3)
    for ids, b in draws[:2]:
        sess.train_round(ids, b, LR, env=_env([0, 2, 3, 5, 6]))
    vel, err = (np.array(b) for b in _banks(sess))
    before = sess.state.params_vec.clone()
    m = sess.train_round(*draws[2], LR, env=_env([]))
    assert m["fedsim/all_dropped"] == 1.0
    assert torch.equal(before, sess.state.params_vec)
    np.testing.assert_array_equal(vel, sess.host_vel)
    np.testing.assert_array_equal(err, sess.host_err)
    sess.close_client_store()


# -- the pipeline, resume, rollback, ladder -----------------------------------


@pytest.mark.parametrize("cache_rows", [0, 4])
def test_depth2_bit_equal_to_depth0_with_collisions(data, cache_rows):
    """16 clients, 8 a round: the cohorts collide inside the depth-2
    window every round, so the staged rows go stale and are gathered
    again at the dispatch; the run stays bit-equal."""
    from commefficient_tpu_torch.pipeline import PipelinedRounds

    kw = {**KW, "num_clients": 16, "client_store": "host",
          "client_store_cache_rows": cache_rows}
    ds = FedDataset(data[0].data, 16, iid=True, seed=0)

    def sampler():
        return FedSampler(ds, num_workers=8, local_batch_size=4, seed=1)

    sync = _session(data[1], **kw)
    samp = sampler()
    for r in range(6):
        sync.train_round(*samp.sample_round(r), LR)
    deep = _session(data[1], **kw, pipeline_depth=2)
    eng = PipelinedRounds(deep.cfg, deep, sampler(), lambda s: LR,
                          num_rounds=6, steps_per_epoch=6).start()

    def full_window(step):
        # rounds step+1 and step+2 gathered before round step writes back
        want = min(2, 5 - step)
        deadline = time.monotonic() + 30
        while (eng._prefetcher.staged_rounds < want
               and time.monotonic() < deadline):
            time.sleep(0.002)

    list(eng.epoch_rounds(0, 0, 6, before_dispatch=full_window))
    eng.close()
    assert torch.equal(sync.state.params_vec, deep.state.params_vec)
    for a, b in zip(_banks(sync), _banks(deep)):
        np.testing.assert_array_equal(a, b)
    assert deep.client_store_stats["regathers"] > 0
    assert sync.client_store_stats["regathers"] == 0
    sync.close_client_store()
    deep.close_client_store()


def test_kill_and_resume_hosted_bit_exact(data, tmp_path):
    kw = {**KW, "client_store": "host"}
    draws = _draws(data[0], Config(**ONE), rounds=8)

    def train(sess, lo, hi, ckpt=None):
        for r in range(lo, hi):
            sess.train_round(*draws[r], lr=0.1 + 0.02 * r)
            if ckpt is not None:
                ckpt.maybe_save(sess, r + 1)

    straight = _session(data[1], **kw)
    train(straight, 0, 8)
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4)
    first = _session(data[1], **kw, **ck)
    train(first, 0, 4, FedCheckpointer(first.cfg))
    first.close_client_store()
    blob = torch.load(tmp_path / "ck" / "step_4.pt", weights_only=True)
    assert "host_vel" in blob and "host_err" in blob
    resumed = _session(data[1], **kw, **ck)
    assert FedCheckpointer(resumed.cfg).restore(resumed) == 4
    train(resumed, 4, 8)
    assert torch.equal(straight.state.params_vec, resumed.state.params_vec)
    for a, b in zip(_banks(straight), _banks(resumed)):
        np.testing.assert_array_equal(a, b)
    # a hosted checkpoint does not restore into a device-bank session
    dev = _session(data[1], **KW, **ck)
    with pytest.raises(ValueError):
        FedCheckpointer(dev.cfg).restore(dev, step=4)


LOCAL = dict(mode="local_topk", error_type="local", local_momentum=0.9,
             virtual_momentum=0.0, k=60)


def test_retry_rollback_hosted_bit_exact(data, tmp_path):
    """The runner's ``retry``: a ``nan_client`` at round 5 rolls back to the
    round-4 snapshot (the hosted banks restored from the vault's copies)
    and the replay is bit-equal to the clean run, which is bit-equal to
    the device banks' clean run."""
    from test_resilience import _last_value
    from test_torch_resilience import _loop

    host = {**LOCAL, "client_store": "host"}
    clean, _, h_clean = _loop(data, tmp_path, "_clean", **host)
    healed, run_dir, h_healed = _loop(
        data, tmp_path, "_healed", **host,
        chaos="nan_client@1:rounds=5-5", recover_policy="retry",
        snapshot_every=4)
    device, _, _ = _loop(data, tmp_path, "_device", **LOCAL)
    assert _last_value(run_dir, "resilience/recoveries") == 1.0
    for other in (healed, device):
        assert torch.equal(clean.state.params_vec, other.state.params_vec)
        for a, b in zip(_banks(clean), _banks(other)):
            np.testing.assert_array_equal(a, b)
    assert [r["loss"] for r in h_clean] == [r["loss"] for r in h_healed]


def test_ladder_rung_switch_on_a_hosted_session(data):
    from commefficient_tpu_torch.control import build_controller

    kw = {**LOCAL, "topk_method": "threshold", "telemetry_level": 1,
          "control_policy": "fixed", "control_schedule": "0-1=0,2-=1",
          "ladder": "k=60,30"}
    draws = _draws(data[0], Config(**ONE), rounds=4)
    out = {}
    for store in ("device", "host"):
        sess = _session(data[1], **kw, **STORES[store])
        ctrl = build_controller(sess.cfg, sess, num_rounds=4)
        ctrl.prewarm()
        for ids, b in draws:
            sess.train_round(ids, b, 0.2)
        assert ctrl.switches == 1 and sess.active_rung == 1
        out[store] = (sess.state.params_vec.clone(), _banks(sess))
        sess.close_client_store()
    assert torch.equal(out["host"][0], out["device"][0])
    for a, b in zip(out["host"][1], out["device"][1]):
        np.testing.assert_array_equal(a, b)
    assert np.abs(out["host"][1][0]).sum() > 0


# -- two gloo ranks -----------------------------------------------------------


def test_two_gloo_ranks_hosted_bit_equal_to_device(data, tmp_path_factory):
    """Each rank's streamer holds the whole bank, gathers its own 4 rows
    and writes back the cohort's 8 (the all-gather the device banks'
    write-back forms): both ranks' banks and params bit-equal to the device
    banks' run, and each rank writes its own ``.r<rank>`` mmap files."""
    ds, params, _ = data
    draws = _draws(ds, Config(**ONE), rounds=4)
    arrays = {f"{layer}/{leaf}": np.asarray(params["params"][layer][leaf])
              for layer in ("Dense_0", "Dense_1")
              for leaf in ("kernel", "bias")}
    arrays["ids"] = np.stack([ids for ids, _ in draws])
    arrays["x"] = np.stack([b["x"] for _, b in draws])
    arrays["y"] = np.stack([b["y"] for _, b in draws])
    two = {**BASE, **KW, "num_devices": 2}
    cases = {"device": two, "host": {**two, "client_store": "host"},
             "mmap": {**two, "client_store": "mmap",
                      "client_store_path": "bank"},
             "cached": {**two, "client_store": "host",
                        "client_store_cache_rows": 4}}
    outs = spawn({"lr": LR, "cases": cases}, arrays, 2, tmp_path_factory)
    dev = outs[0]
    for out in outs:
        for store in ("host", "mmap", "cached"):
            for key in ("losses", "params"):
                np.testing.assert_array_equal(out[f"{store}/{key}"],
                                              dev[f"device/{key}"])
            np.testing.assert_array_equal(out[f"{store}/host_vel"],
                                          dev["device/client_vel"])
            np.testing.assert_array_equal(out[f"{store}/host_err"],
                                          dev["device/client_err"])
            assert f"{store}/client_vel" not in out
    files = set(outs[0]["mmap/bank_files"]) | set(outs[1]["mmap/bank_files"])
    assert files == {f"bank.{b}.r{r}" for b in ("vel", "err")
                     for r in (0, 1)}


# -- a population the device banks cannot hold --------------------------------

_MILLION_CHILD = textwrap.dedent("""
    import resource, sys
    kind, root = sys.argv[1], sys.argv[2]
    # under ONE [1e6, 212] f32 bank (848 MB); torch's import fits, and the
    # mmap banks are file mappings, which RLIMIT_DATA does not count
    LIM = 700_000_000
    resource.setrlimit(resource.RLIMIT_DATA, (LIM, LIM))
    try:
        import numpy as np
        import torch
        torch.set_num_threads(1)
        sys.path.insert(0, root)
        from commefficient_tpu_torch.models import classification_loss
        from commefficient_tpu_torch.parallel import FederatedSession
        from commefficient_tpu_torch.utils.config import Config

        def mlp(params, x):
            p = params["params"]
            h = torch.relu(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
            return h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]

        rng = np.random.default_rng(0)
        params = {"params": {
            "Dense_0": {"kernel": rng.normal(size=(8, 16)).astype("f4"),
                        "bias": np.zeros(16, "f4")},
            "Dense_1": {"kernel": rng.normal(size=(16, 4)).astype("f4"),
                        "bias": np.zeros(4, "f4")}}}
        C = 1_000_000
        cfg = Config(mode="local_topk", error_type="local",
                     local_momentum=0.9, k=8, num_clients=C, num_workers=4,
                     num_devices=1, local_batch_size=2, weight_decay=0.0,
                     seed=0, client_store=kind, device="cpu",
                     client_store_path=(sys.argv[3] + "/bank"
                                        if kind == "mmap" else ""))
        sess = FederatedSession(cfg, params, classification_loss(mlp))
        ids = np.array([3, 999_999, 123_456, 500_000])
        batch = {"x": rng.normal(size=(4, 2, 8)).astype(np.float32),
                 "y": rng.integers(0, 4, size=(4, 2)).astype(np.int32)}
        for _ in range(2):
            m = sess.train_round(ids, batch, 0.1)
        assert np.isfinite(float(m["loss"]))
        rows = sess._streamer.vel_store.gather_rows(ids)
        assert np.abs(rows).sum() > 0  # the rows landed in the bank
        sess.close_client_store()
        print("OK")
    except Exception as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(7)
""")


def _run_million(kind, tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_MILLION_CHILD)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(script), kind, ROOT,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)


def test_million_clients_mmap_trains_where_the_device_banks_cannot(tmp_path):
    ok = _run_million("mmap", tmp_path)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "OK" in ok.stdout
    dev = _run_million("device", tmp_path)
    assert dev.returncode == 7, (dev.returncode, dev.stderr[-2000:])
    assert "alloc" in dev.stderr.lower(), dev.stderr[-2000:]


# -- C.4: no range plan built after the prewarm -------------------------------


@pytest.mark.parametrize("decode", [
    dict(topk_method="threshold", sketch_decode="sharded"),
    dict(num_blocks=4),
])
def test_prewarmed_ladder_reads_only_built_range_plans(data, decode,
                                                       monkeypatch):
    """Each range-form estimate a round (and a ``num_cols`` migration)
    asks for looks up its plan as the card's wrapper does; after
    ``prepare_plans`` of every rung with the session's slices, a run that
    visits every rung of a 4-rung ladder builds none."""
    from commefficient_tpu_torch.control import build_controller

    looked = []
    plain = kern.estimate_at_range_torch

    def traced(spec, table, start, n):
        looked.append((spec, start, n))
        kern._range_plan(spec, start, n, "cpu", table.element_size())
        return plain(spec, table, start, n)

    monkeypatch.setattr(kern, "estimate_at_range_torch", traced)
    kw = {**SKETCH_LM, "local_momentum": 0.0, **decode,
          "control_policy": "fixed", "ladder": "num_cols=256,224,192,160",
          "control_schedule": "0-0=0,1-1=1,2-2=2,3-3=3,4-=0"}
    sess = _session(data[1], **kw)
    ctrl = build_controller(sess.cfg, sess, num_rounds=6)
    assert len(sess.rungs) == 4
    for rung in sess.rungs:
        kern.prepare_plans(rung.spec, "cpu",
                           slices=sess.rung_range_slices(rung))
    built = kern.plan_builds()
    for ids, b in _draws(data[0], sess.cfg, rounds=6):
        sess.train_round(ids, b, LR)
    assert ctrl.switches == 4
    assert len({s for s, _, _ in looked}) == 4  # every rung's spec read
    assert kern.plan_builds() == built
    assert kern._range_plan.cache_info().maxsize is None

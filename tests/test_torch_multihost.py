"""multihost/ on the CPU, against the reference's ``commefficient_tpu/
multihost/`` (counterparts of its tests/test_multihost.py and of
tests/test_fleet.py's multi-host satellites).

What is held:

* **topology**: ``slot_partition``, ``client_partition``,
  ``HostTopology`` (``at_width`` included) and ``build_topology`` equal to
  the reference's for the same ints; the group/topology cross-check;
* **config**: every refusal of the reference's ``_validate_multihost``,
  parametrized against its ``Config`` with the same keywords;
* **bring-up**: the one env:// bring-up (``parallel.mesh``'s
  ``_connect_with_retry`` and ``join_from_env``, behind
  ``initialize_multihost`` and the train entries' ``distributed_from_env``)
  with ``torch.distributed.init_process_group`` and ``time.sleep`` patched
  (as the reference's tests patch ``initialize_distributed``): the
  doubling backoff, the spent budget naming the coordinator, the floor of
  one dial, one dial without ``--distributed``, the missing environment
  and a node count that is not ``num_hosts``;
* **data plane**: the partitioned draws and realized batches equal to the
  reference's ``HostDataPlane`` round by round; its refusals; fedsim env
  slices; the per-host client bank; ``assemble_rows`` and
  ``assemble_cohort``;
* **twins on four gloo ranks** (one spawn of tests/test_torch_gloo_worker
  .py, ``num_devices 4``, ``num_workers 8``, TinyMLP): ``num_hosts=2``
  bit-equal to ``num_hosts=1`` (sketch, uncompressed, local_topk, fedsim's
  bernoulli masks, a checkpoint resume: drained losses identical, every
  FedState leaf equal), and within the gloo twins' tolerances (losses
  ``rtol 1e-4``, params ``atol 1e-5``, tables ``atol 1e-5 * max``) of the
  reference's mesh-faked run at ``num_devices=4, num_hosts=2``; round 0's
  ``CollectiveCounter`` snapshot equal between the twins op by op (the
  port's form of the reference's one cross-host all-reduce); the
  ``multihost/*`` scalars at level 1 and the ``perf_report.json`` block
  with two hosts, neither with one; a batch whose other hosts' rows are
  NaN training bit-equal to the full batch;
* **the two-level butterfly** keeping log2(W) hops, the intra-host bits
  first (its partners recorded in order on a stand-in group; its values
  on four gloo ranks are tests/test_torch_sparse_aggregate.py's);
* **two nodes**: two processes joined by ``--distributed`` as two nodes of
  one rank each (``WORLD_SIZE 2``, ``LOCAL_WORLD_SIZE 1``), each realizing
  only its own host's rows: the same loss on both, within the twins'
  tolerance of the reference's mesh-faked run fed the same per-host
  cohorts.
"""

import json
import os
import socket
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from commefficient_tpu.data import FedDataset as RefDataset
from commefficient_tpu.fedsim import build_environment as ref_build_env
from commefficient_tpu.multihost import HostDataPlane as RefPlane
from commefficient_tpu.multihost import HostTopology as RefTopology
from commefficient_tpu.multihost import build_topology as ref_build_topology
from commefficient_tpu.multihost import client_partition as ref_client_part
from commefficient_tpu.multihost import global_client_ids as ref_global_ids
from commefficient_tpu.multihost import round_env_slice as ref_env_slice
from commefficient_tpu.multihost import slot_partition as ref_slot_part
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.data import FedDataset
from commefficient_tpu_torch.fedsim import build_environment
from commefficient_tpu_torch.multihost import (
    MULTIHOST_STREAM,
    HostDataPlane,
    HostTopology,
    assemble_cohort,
    assemble_rows,
    build_host_bank,
    build_topology,
    client_partition,
    global_client_ids,
    round_env_slice,
    slot_partition,
    validate_mesh_topology,
)
from commefficient_tpu_torch.multihost import bringup
from commefficient_tpu_torch.multihost.dataplane import _PartitionStoreCfg
from commefficient_tpu_torch.ops.collectives import sparse_allreduce_sharded
from commefficient_tpu_torch.parallel import mesh
from commefficient_tpu_torch.utils.config import _UNPORTED, Config
from test_round import BASE, _setup
from test_torch_gloo_worker import spawn
from test_torch_sharded_decode import (  # noqa: F401  (the fixture)
    LR,
    _assert_twin,
    _ref_run,
    rounds,
)
from test_torch_sparse_aggregate import job_arrays

HERE = os.path.dirname(os.path.abspath(__file__))
TOPO_FIELDS = ("num_hosts", "host_id", "num_workers", "num_clients",
               "chips_per_host", "slot_range", "client_range")


def _fields(t):
    return tuple(getattr(t, f) for f in TOPO_FIELDS)


# -- topology -----------------------------------------------------------------


def test_partitions_tile_their_ranges_as_the_reference():
    assert slot_partition(8, 2, 0) == (0, 4)
    assert slot_partition(8, 2, 1) == (4, 8)
    with pytest.raises(ValueError, match="divisible"):
        slot_partition(8, 3, 0)
    with pytest.raises(ValueError, match="host_id"):
        slot_partition(8, 2, 2)
    with pytest.raises(ValueError, match="host_id"):
        client_partition(12, 2, -1)
    for C, H in ((12, 2), (13, 2), (10, 4), (7, 4), (100, 8)):
        ranges = [client_partition(C, H, h) for h in range(H)]
        assert ranges == [ref_client_part(C, H, h) for h in range(H)]
        flat = [c for lo, hi in ranges for c in range(lo, hi)]
        assert flat == list(range(C)), (C, H, ranges)
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1
    for W, H in ((8, 2), (8, 4), (16, 8), (4, 1)):
        assert [slot_partition(W, H, h) for h in range(H)] == [
            ref_slot_part(W, H, h) for h in range(H)]


def test_build_topology_equals_the_reference_and_cross_checks_the_group():
    kw = dict(mode="uncompressed", num_hosts=2, **BASE)
    cfg, ref_cfg = Config(**kw), RefConfig(**kw)
    for h in range(2):
        t = build_topology(cfg, host_id=h)
        assert _fields(t) == _fields(ref_build_topology(ref_cfg, host_id=h))
        assert (t.workers_per_host, t.clients_per_host) == (4, 6)
        assert t.slot_range == (4 * h, 4 * h + 4)
    t0, t1 = (build_topology(cfg, host_id=h) for h in range(2))
    assert t0.owns_client(t0.client_range[0])
    assert not t0.owns_client(t1.client_range[0])
    assert t0.local_client(t0.client_range[0]) == 0
    with pytest.raises(ValueError, match="partition"):
        t0.local_client(t1.client_range[0])
    # without a process group this process is host 0
    assert build_topology(cfg).host_id == 0
    validate_mesh_topology(types.SimpleNamespace(hosts=2), t0)
    with pytest.raises(ValueError, match="declares 1 host"):
        validate_mesh_topology(types.SimpleNamespace(hosts=1), t0)


def test_worker_group_carries_the_host_axis(monkeypatch):
    """A group of 4 ranks over 2 hosts is host-major: rank r on host
    r // 2 of 2 ranks a host (the reference's ``worker_axes``); without
    hosts one host of 4; a world that does not split is refused."""
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda group=None: 4)
    for r in range(4):
        monkeypatch.setattr(mesh.dist, "get_rank", lambda group=None, r=r: r)
        g = mesh.DistributedWorkers(hosts=2)
        assert (g.hosts, g.host_id, g.workers_per_host) == (2, r // 2, 2)
        one = mesh.DistributedWorkers()
        assert (one.hosts, one.host_id, one.workers_per_host) == (1, 0, 4)
    with pytest.raises(ValueError, match="does not split into 3 host"):
        mesh.DistributedWorkers(hosts=3)
    assert (mesh.SingleWorker.hosts, mesh.SingleWorker.host_id,
            mesh.SingleWorker.workers_per_host) == (1, 0, 1)


def test_host_topology_at_width_as_the_reference():
    kw = dict(num_hosts=2, host_id=1, num_workers=8, num_clients=100,
              chips_per_host=4, slot_range=(4, 8), client_range=(50, 100))
    topo, ref = HostTopology(**kw), RefTopology(**kw)
    narrowed = topo.at_width(4)
    assert _fields(narrowed) == _fields(ref.at_width(4))
    assert narrowed.slot_range == (2, 4) and narrowed.workers_per_host == 2
    assert narrowed.chips_per_host == 4
    assert narrowed.client_range == (50, 100)
    assert topo.at_width(8) is topo
    with pytest.raises(ValueError):
        topo.at_width(5)


# -- config -------------------------------------------------------------------

# the reference's refusals of _validate_multihost: keywords over BASE and
# a phrase both messages hold
MULTIHOST_REFUSALS = {
    "hosts_below_one": (dict(num_hosts=0), "num_hosts must be >= 1"),
    "retries_below_one": (dict(distributed_connect_retries=0),
                          "distributed_connect_retries must be >= 1"),
    "distributed_one_host": (dict(distributed=True), "num_hosts >= 2"),
    "not_power_of_two": (dict(num_hosts=3, num_workers=6, num_devices=6),
                         "power of two"),
    "devices_not_divisible": (dict(num_hosts=16), "divisible by num_hosts"),
    "fsdp": (dict(num_hosts=2, fsdp=True), "workers axis"),
    "model_axis": (dict(num_hosts=2, model_axis=2, num_devices=16,
                        num_workers=16, num_clients=32), "workers axis"),
    "seq_axis": (dict(num_hosts=2, seq_axis=2, num_devices=16,
                      num_workers=16, num_clients=32), "workers axis"),
}


@pytest.mark.parametrize("name", sorted(MULTIHOST_REFUSALS))
def test_config_refuses_what_the_reference_refuses_of_multihost(name):
    kw, phrase = MULTIHOST_REFUSALS[name]
    args = {"mode": "uncompressed", **BASE, **kw}
    with pytest.raises(ValueError, match=phrase) as port:
        Config(**args)
    with pytest.raises(ValueError, match=phrase) as ref:
        RefConfig(**args)
    if name not in ("distributed_one_host", "fsdp", "model_axis",
                    "seq_axis", "devices_not_divisible"):
        # the messages that name nothing of JAX are the reference's
        assert str(port.value) == str(ref.value)


def test_only_the_parallelism_layouts_stay_unported():
    # ROADMAP A17 lifted the parallelism layouts too: nothing is refused
    # as unported, and the host axis still refuses them (above)
    assert sorted(_UNPORTED) == []
    kw = dict(mode="uncompressed", num_hosts=2, distributed=True,
              distributed_connect_retries=5, **BASE)
    cfg, ref = Config(**kw), RefConfig(**kw)
    assert (cfg.num_hosts, cfg.distributed, cfg.distributed_connect_retries
            ) == (ref.num_hosts, ref.distributed,
                  ref.distributed_connect_retries)


# -- bring-up -----------------------------------------------------------------

COORD = {"MASTER_ADDR": "10.0.0.7", "MASTER_PORT": "8476", "WORLD_SIZE": "2",
         "RANK": "0"}
DIST = dict(distributed=True, num_hosts=2, num_devices=2, num_workers=2,
            num_clients=4, device="cpu")


@pytest.fixture
def no_group(monkeypatch):
    """The bring-up sees no initialized group and dials through a patched
    ``init_process_group`` (the list of its calls)."""
    calls = []
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


def test_connect_retries_then_succeeds(monkeypatch, no_group):
    for k, v in COORD.items():
        monkeypatch.setenv(k, v)
    naps = []
    monkeypatch.setattr(mesh.time, "sleep", naps.append)

    def flaky(**kw):
        no_group.append(kw)
        if len(no_group) < 3:
            raise RuntimeError("connection refused")

    monkeypatch.setattr(mesh.dist, "init_process_group", flaky)
    mesh._connect_with_retry(Config(**DIST))
    assert len(no_group) == 3
    assert naps == [1.0, 2.0]  # the backoff doubles from 1 s
    assert no_group[-1] == {"backend": "gloo", "init_method": "env://"}
    # without --distributed (a torchrun group on one node): one dial
    no_group.clear()
    with pytest.raises(RuntimeError, match="1 attempt"):
        mesh._connect_with_retry(Config(device="cpu"))
    assert len(no_group) == 1 and naps == [1.0, 2.0]


def test_connect_spent_names_the_coordinator(monkeypatch, no_group):
    for k, v in COORD.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh.time, "sleep", lambda _s: None)

    def dead(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(mesh.dist, "init_process_group", dead)
    with pytest.raises(RuntimeError, match="10.0.0.7:8476") as ei:
        mesh._connect_with_retry(
            Config(distributed_connect_retries=2, **DIST))
    msg = str(ei.value)
    assert "2 attempt(s)" in msg and "connection refused" in msg
    assert isinstance(ei.value.__cause__, RuntimeError)
    with pytest.raises(ValueError, match="distributed_connect_retries"):
        Config(distributed_connect_retries=0)
    # a duck-typed config below one attempt still dials once
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda **kw: no_group.append(kw))

    class _Cfg:
        distributed = True
        distributed_connect_retries = 0

    mesh._connect_with_retry(_Cfg())
    assert len(no_group) == 1


def test_initialize_multihost_refuses_a_missing_environment(monkeypatch,
                                                             no_group):
    for k in COORD:
        monkeypatch.delenv(k, raising=False)
    base = dict(num_hosts=2, num_devices=2, num_workers=2, num_clients=4,
                device="cpu")
    assert bringup.initialize_multihost(Config(**base)) is False
    with pytest.raises(RuntimeError) as ei:
        bringup.initialize_multihost(Config(distributed=True, **base))
    for k in COORD:
        assert k in str(ei.value)
    # the train entries' bring-up is the same one
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        with mesh.distributed_from_env(Config(distributed=True, **base)):
            pass
    assert no_group == []  # nothing dialed


def test_initialize_multihost_refuses_a_cluster_of_other_nodes(monkeypatch,
                                                                no_group):
    for k, v in COORD.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda: 2)
    base = dict(distributed=True, num_hosts=2, num_workers=4, num_clients=8,
                device="cpu")
    # two ranks on ONE node: a cluster of 1 node, not num_hosts = 2
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="1-node cluster.*--num_hosts 1"):
        bringup.initialize_multihost(Config(num_devices=2, **base))
    # two nodes of one rank, but four devices asked for
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="--num_devices 2"):
        bringup.initialize_multihost(Config(num_devices=4, **base))
    assert bringup.initialize_multihost(Config(num_devices=2, **base))
    assert Config(num_devices=2, **base).num_processes == 2
    assert Config(num_hosts=2, num_devices=2, num_workers=4,
                  num_clients=8).num_processes == 1


# -- the data plane -----------------------------------------------------------


def _planes(num_hosts=2, num_clients=12, seed=7):
    kw = dict(mode="uncompressed", num_hosts=num_hosts,
              **{**BASE, "num_clients": num_clients})
    cfg, ref_cfg = Config(**kw), RefConfig(**kw)
    ds, _, _ = _setup(num_clients)
    port_ds = FedDataset(ds.data, num_clients, iid=True, seed=0)
    planes = [HostDataPlane(port_ds, build_topology(cfg, host_id=h),
                            local_batch_size=cfg.local_batch_size, seed=seed)
              for h in range(num_hosts)]
    refs = [RefPlane(ds, ref_build_topology(ref_cfg, host_id=h),
                     local_batch_size=cfg.local_batch_size, seed=seed)
            for h in range(num_hosts)]
    return cfg, port_ds, planes, refs


def test_dataplane_draws_and_batches_equal_the_reference():
    cfg, _, planes, refs = _planes()
    assert MULTIHOST_STREAM == 0x40057
    for rnd in range(3):
        for p, r in zip(planes, refs):
            ids = p.sample_clients(rnd)
            np.testing.assert_array_equal(ids, r.sample_clients(rnd))
            assert ids.dtype == np.int32 and len(set(ids.tolist())) == 4
            lo, hi = p.topology.client_range
            assert ((ids >= lo) & (ids < hi)).all()
            got_ids, got = p.sample_round(rnd)
            want_ids, want = r.sample_round(rnd)
            np.testing.assert_array_equal(got_ids, want_ids)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            assert got["x"].shape[:2] == (4, cfg.local_batch_size)
        np.testing.assert_array_equal(global_client_ids(planes, rnd),
                                      ref_global_ids(refs, rnd))
    local = [p.sample_clients(0) - p.topology.client_range[0]
             for p in planes]
    assert not np.array_equal(local[0], local[1])
    assert planes[0].steps_per_epoch() == refs[0].steps_per_epoch()
    assert [i.tolist() for i, _ in planes[1].epoch(1)] == [
        i.tolist() for i, _ in refs[1].epoch(1)]


def test_dataplane_refuses_mismatched_geometry():
    cfg, ds, _, _ = _planes()
    with pytest.raises(ValueError, match="clients"):
        HostDataPlane(ds, build_topology(cfg.replace(num_clients=20),
                                         host_id=0), local_batch_size=4)
    starved = HostTopology(num_hosts=2, host_id=0, num_workers=8,
                           num_clients=8, chips_per_host=4,
                           slot_range=(0, 4), client_range=(0, 2))
    ds8 = FedDataset(ds.data, 8, iid=True, seed=0)
    with pytest.raises(ValueError, match="distinct cohort slots"):
        HostDataPlane(ds8, starved, local_batch_size=4)


def test_round_env_slices_tile_the_global_env_as_the_reference():
    kw = dict(mode="uncompressed", num_hosts=2, availability="bernoulli",
              dropout_prob=0.4, **BASE)
    cfg, ref_cfg = Config(**kw), RefConfig(**kw)
    env = build_environment(cfg).round_env(0)
    ref_env = ref_build_env(ref_cfg).round_env(0)
    slices = [round_env_slice(env, build_topology(cfg, host_id=h))
              for h in range(2)]
    np.testing.assert_array_equal(np.concatenate([s.live for s in slices]),
                                  env.live)
    np.testing.assert_array_equal(
        np.concatenate([s.corrupt for s in slices]), env.corrupt)
    for h, s in enumerate(slices):
        want = ref_env_slice(ref_env, ref_build_topology(ref_cfg, host_id=h))
        np.testing.assert_array_equal(s.live, np.asarray(want.live))
        assert s.live_count == env.live_count == want.live_count
        assert s.stats == env.stats


def test_host_bank_partition_sized_and_refuses_foreign_ids():
    kw = dict(mode="local_topk", error_type="local", k=30,
              client_store="host", num_hosts=2, **BASE)
    cfg = Config(**kw)
    topo = build_topology(cfg, host_id=1)
    bank = build_host_bank(cfg, topo, row_dim=16, needs_vel=False,
                           needs_err=True)
    assert bank is not None and bank.has_err and not bank.has_vel
    try:
        assert bank.err_array().shape == (topo.clients_per_host, 16)
        lo, hi = topo.client_range
        own = np.arange(lo, min(lo + 2, hi), dtype=np.int32)
        cohort = bank.gather(own)
        assert cohort.err.shape[0] == own.size
        with pytest.raises(ValueError, match="partition"):
            bank.gather(np.asarray([0], dtype=np.int32))  # host 0's client
    finally:
        bank.close()
    assert build_host_bank(cfg.replace(client_store="device"), topo,
                           row_dim=16, needs_vel=False,
                           needs_err=True) is None
    mm = _PartitionStoreCfg(cfg.replace(client_store="mmap",
                                        client_store_path="bank"), topo)
    assert (mm.client_store_path, mm.num_clients) == ("bank.h1", 6)


def _rank(rank, size=4):
    return types.SimpleNamespace(rank=rank, size=size)


def test_assemble_rows_writes_only_this_ranks_rows_and_refuses():
    """Four ranks over two hosts: each rank's two rows come from its own
    host's slice; a slice this rank covers missing, a ragged slice and a
    group whose rows straddle hosts are refused in the reference's
    words."""
    rows = {h: np.arange(4 * 3, dtype=np.float32).reshape(4, 3) + 100 * h
            for h in range(2)}
    full = np.concatenate([rows[0], rows[1]])
    for r in range(4):
        h = r // 2
        out = assemble_rows(_rank(r), {h: rows[h]}, num_hosts=2)
        assert out.shape == (8, 3)
        np.testing.assert_array_equal(out[2 * r:2 * r + 2],
                                      full[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="every host slice"):
        assemble_rows(_rank(2), {0: rows[0]}, num_hosts=2)
    with pytest.raises(ValueError, match="rows, expected"):
        assemble_rows(_rank(0), {0: rows[0], 1: rows[1][:2]}, num_hosts=2)
    with pytest.raises(ValueError, match="straddle a host boundary"):
        assemble_rows(_rank(0, size=1), rows, num_hosts=2)
    with pytest.raises(ValueError, match="empty"):
        assemble_rows(_rank(0), {}, num_hosts=2)
    # the cohort bridge: every host's ids, this rank's host's rows only
    _, _, planes, _ = _planes()
    parts = [planes[0].sample_round(0), (planes[1].sample_clients(0), None)]
    ids, batch = assemble_cohort(_rank(1), parts)
    np.testing.assert_array_equal(ids, global_client_ids(planes, 0))
    for k, v in parts[0][1].items():
        np.testing.assert_array_equal(batch[k][2:4], v[2:4])


# -- the two-level butterfly --------------------------------------------------


class _Partners:
    """A stand-in group of ``size`` ranks that records each exchange's
    partner (and sends nothing back)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size
        self.partners = []

    def exchange(self, t, partner):
        self.partners.append(partner)
        return torch.zeros_like(t)


def test_two_level_butterfly_keeps_log2_hops_intra_host_first():
    v = torch.zeros(64)
    v[[3, 17, 40]] = 1.0
    for W, H in ((8, 2), (8, 4), (4, 2)):
        for me in range(W):
            g = _Partners(me, W)
            sparse_allreduce_sharded(v, 3, g, axis_sizes=(H, W // H))
            per = W // H
            bits = [1 << i for i in range(per.bit_length() - 1)] + [
                per << i for i in range(H.bit_length() - 1)]
            assert len(bits) == int(np.log2(W))
            # two exchanges a hop (indices, values), intra-host first
            assert g.partners == [me ^ b for b in bits for _ in range(2)]
            assert all(p // per == me // per
                       for p in g.partners[:2 * (len(bits) - int(
                           np.log2(H)))])


# -- four gloo ranks: the host axis changes no sum ----------------------------

FOUR = {**BASE, "num_devices": 4}
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=40, num_rows=3, num_cols=512)
TWIN_CASES = {
    "uncompressed": dict(mode="uncompressed", error_type="none"),
    "sketch": SKETCH,
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=30),
    "fedsim": {**SKETCH, "availability": "bernoulli", "dropout_prob": 0.3},
}
LEVEL1 = {**SKETCH, "sketch_decode": "dense", "telemetry_level": 1}
TRACE = {**LEVEL1, "num_epochs": 1, "max_rounds": 3}


def _hosts(kw, h):
    return {**FOUR, **kw, "num_hosts": h}


@pytest.fixture(scope="module")
def four_ranks(rounds, tmp_path_factory):
    ds = rounds[0]
    job = {"lr": LR,
           "cases": {f"{n}_h{h}": _hosts(kw, h)
                     for n, kw in TWIN_CASES.items() for h in (1, 2)},
           "resume": {f"sketch_h{h}": _hosts(SKETCH, h) for h in (1, 2)},
           "multihost": {f"level1_h{h}": _hosts(LEVEL1, h) for h in (1, 2)},
           "foreign_nan": ["sketch_h2"],
           "trace": {f"level1_h{h}": _hosts(TRACE, h) for h in (1, 2)}}
    arrays = {**job_arrays(rounds), "trace/x": ds.data["x"][:96],
              "trace/y": ds.data["y"][:96]}
    return spawn(job, arrays, 4, tmp_path_factory)


def _case(outs, name):
    """Rank 0's outputs of one case, every rank holding the same."""
    keys = [k for k in outs[0] if k.startswith(name + "/")]
    assert keys, name
    for out in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k])
    return {k.split("/", 1)[1]: outs[0][k] for k in keys}


@pytest.mark.parametrize("name", sorted(TWIN_CASES) + ["resume:sketch"])
def test_two_hosts_bit_equal_to_one_host(four_ranks, name):
    one, two = _case(four_ranks, f"{name}_h1"), _case(four_ranks,
                                                      f"{name}_h2")
    assert one.keys() == two.keys()
    assert one["losses"].tolist() == two["losses"].tolist()
    for k in one:
        np.testing.assert_array_equal(two[k], one[k])


@pytest.mark.parametrize("name", sorted(TWIN_CASES) + ["resume:sketch"])
def test_two_hosts_match_the_reference_meshfaked_twin(rounds, four_ranks,
                                                      name):
    got = _case(four_ranks, f"{name}_h2")
    kw = TWIN_CASES[name.split(":")[-1]]
    want = _ref_run(rounds, _hosts(kw, 2))  # the resume: the straight run
    leaves = ("momentum", "error") + (("client_err",)
                                      if "client_err" in got else ())
    _assert_twin(got, want, leaves=leaves)


def test_round0_collectives_equal_between_the_twins(four_ranks):
    r, c = 3, None
    for rank, out in enumerate(four_ranks):
        one = json.loads(str(out["mh:level1_h1/collectives"]))
        two = json.loads(str(out["mh:level1_h2/collectives"]))
        assert one == two, rank
        ar = two["ops"]["all-reduce"]
        assert ar["count"] >= 1
        c = two["max_all_reduce_elems"] // r
        assert ar["bytes"] >= 4 * r * c
    assert c >= 512  # the [3, c] table is the largest all-reduce


def test_multihost_scalars_ride_level1_rounds(four_ranks):
    keys = ["multihost/cross_host_bytes", "multihost/dcn_exposed_ms",
            "multihost/host_id", "multihost/num_processes"]
    for rank, out in enumerate(four_ranks):
        assert out["mh:level1_h1/keys"].tolist() == []
        assert out["mh:level1_h2/keys"].tolist() == keys
        assert out["mh:level1_h1/group"].tolist() == [1, 0, 4]
        assert out["mh:level1_h2/group"].tolist() == [2, rank // 2, 2]
        assert (out["mh:level1_h2/multihost/host_id"] == rank // 2).all()
        assert (out["mh:level1_h2/multihost/num_processes"] == 1.0).all()
        assert (out["mh:level1_h2/multihost/dcn_exposed_ms"] == 0.0).all()
        up = out["mh:level1_h2/multihost/cross_host_bytes"]
        assert (up == up[0]).all() and up[0] > 0


def test_perf_report_carries_the_multihost_block(four_ranks):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema", Path(HERE).parent / "scripts"
        / "check_telemetry_schema.py")
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    reports = {}
    for h in (1, 2):
        run_dir = Path(str(four_ranks[0][f"trace:level1_h{h}/run_dir"]))
        checker.validate_run_dir(run_dir)
        reports[h] = json.loads((run_dir / "perf_report.json").read_text())
        np.testing.assert_array_equal(
            four_ranks[3][f"trace:level1_h{h}/params"],
            four_ranks[0][f"trace:level1_h{h}/params"])
    assert "multihost" not in reports[1]
    assert reports[2]["multihost"] == {"num_hosts": 2, "num_processes": 1,
                                       "host_id": 0}
    assert reports[1]["collectives"]["ops"] == reports[2]["collectives"][
        "ops"]
    np.testing.assert_array_equal(four_ranks[0]["trace:level1_h1/params"],
                                  four_ranks[0]["trace:level1_h2/params"])


def test_foreign_rows_are_never_read(four_ranks):
    """The 2-host sketch run fed batches whose other hosts' rows are NaN
    (``assemble_rows`` of this rank's host alone) trains the full batch's
    bits."""
    for out in four_ranks:
        np.testing.assert_array_equal(out["nan:sketch_h2/params"],
                                      out["sketch_h2/params"])
        assert out["nan:sketch_h2/losses"].tolist() == \
            out["sketch_h2/losses"].tolist()
        assert np.isfinite(out["nan:sketch_h2/losses"]).all()


# -- two nodes ----------------------------------------------------------------

NODE_FLAGS = ["--mode", "sketch", "--error_type", "virtual",
              "--virtual_momentum", "0.9", "--k", "8", "--num_rows", "3",
              "--num_cols", "64", "--num_clients", "16", "--num_workers",
              "8", "--local_batch_size", "4", "--weight_decay", "0.0",
              "--seed", "5"]
NODE_ROUNDS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_nodes_distributed_round(rounds, tmp_path):
    """Two processes, one node each (``--distributed``): each realizes its
    own host's rows; both report the same losses and params, equal within
    the twins' tolerance to the reference's mesh-faked run
    (``num_devices=2, num_hosts=2``) fed the same per-host cohorts."""
    ds, params, loss_ref, _ = rounds
    arrays = job_arrays(rounds)
    arrays.update({"node/x": ds.data["x"], "node/y": ds.data["y"],
                   "node/rounds": np.asarray(NODE_ROUNDS),
                   "node/lr": np.asarray(LR)})
    np.savez(tmp_path / "in.npz", **arrays)
    port = str(_free_port())
    flags = NODE_FLAGS + ["--device", "cpu", "--distributed", "true",
                          "--num_hosts", "2", "--num_devices", "2"]
    procs = []
    for r in range(2):
        env = {**os.environ, "WORLD_SIZE": "2", "RANK": str(r),
               "GROUP_RANK": str(r), "LOCAL_RANK": "0",
               "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "test_torch_gloo_worker.py"),
             "node", str(tmp_path / "in.npz"), str(tmp_path / f"n{r}.npz"),
             *flags], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = [dict(np.load(tmp_path / f"n{r}.npz")) for r in range(2)]
    assert [int(o["node/host_id"]) for o in outs] == [0, 1]
    assert [int(o["node/world"]) for o in outs] == [2, 2]
    assert outs[0]["node/losses"].tolist() == outs[1]["node/losses"].tolist()
    np.testing.assert_array_equal(outs[0]["node/params"],
                                  outs[1]["node/params"])

    # the reference's mesh-faked run on the same per-host cohorts
    kw = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=8, num_rows=3, num_cols=64, num_clients=16, num_workers=8,
              local_batch_size=4, weight_decay=0.0, seed=5, num_devices=2,
              num_hosts=2)
    ref_cfg = RefConfig(**kw)
    ref_ds = RefDataset(ds.data, 16, iid=True, seed=0)
    planes = [RefPlane(ref_ds, ref_build_topology(ref_cfg, host_id=h),
                       local_batch_size=4, seed=5) for h in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = RefSession(ref_cfg, params, loss_ref)
    losses = []
    for r in range(NODE_ROUNDS):
        parts = [p.sample_round(r) for p in planes]
        ids = np.concatenate([i for i, _ in parts])
        np.testing.assert_array_equal(outs[0]["node/ids"][r], ids)
        batch = {k: np.concatenate([b[k] for _, b in parts])
                 for k in parts[0][1]}
        losses.append(float(sess.train_round(ids, batch, LR)["loss"]))
    np.testing.assert_allclose(outs[0]["node/losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(outs[0]["node/params"],
                               np.asarray(sess.state.params_vec), rtol=0,
                               atol=1e-5)

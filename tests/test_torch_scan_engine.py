"""The scan engine (``pipeline/scan_engine.py``, ``--scan_rounds K > 1``)
on the CPU, at tests/test_round.py's TinyMLP size (counterparts of the
reference's tests/test_scan_engine.py).

On the card a block of up to K rounds is one replay of a CUDA graph; on
the CPU the engine runs the same block closure as a loop, with the same
staging (an epoch's ids, indices, plans, f32 lrs and fedsim environments
copied once), packs, signatures and sentinel. What is held here:

* the port against itself: ``ScanRounds`` at K = 3 bit-equal to the
  per-round dispatch in every state leaf and the drained scalar
  sequence (the exact decode, the threshold decode, the sharded decode,
  fedsim masks, DP noise drawn before the block, local_topk's device
  banks, powersgd without the warm start, its fresh Qs staged before
  the block), and through ``run_train_loop`` across a checkpoint resume
  and a ``retry`` recovery;
* the port against the reference's ``ScanRounds`` on the same config and
  seed (params ``rtol 1e-4 / atol 1e-5``, tables ``1e-5 * max|table|``,
  losses ``rtol 1e-4``), powersgd without the warm start fed the
  reference's Qs (the two PRNGs differ);
* the block plan equal to the reference's over a grid of ranges, K and
  gates; the ``Config`` refusals in the reference's words;
* the retrace sentinel: a changed signature is a counted re-capture and
  a ``RetraceError`` naming the diff under ``max_retraces=0``;
  ``xla/retraces`` at level >= 1 on both paths;
* the capturable round: ``topk_static`` (the selection a capture takes)
  equal to ``topk_sparsify`` in set and order, ties included, and the
  block program, with the selections in their capture forms, reading
  nothing back to the host (no ``item``, no ``nonzero``).

The graph itself (capture, replay, launch accounting) needs the card:
``tests/test_torch_cuda_kernels.py`` holds it under the ``cuda`` marker.
"""

import dataclasses
import json
import os
import types
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.pipeline import ScanRounds as RefScan
from commefficient_tpu.telemetry.xla_audit import (
    RetraceSentinel as RefSentinel,
)
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops import topk as topk_mod
from commefficient_tpu_torch.ops.countsketch import topk_scatter
from commefficient_tpu_torch.ops.topk import (
    topk_dense,
    topk_sparsify,
    topk_static,
)
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.round import DeviceEnv
from commefficient_tpu_torch.pipeline import ScanRounds
from commefficient_tpu_torch.pipeline.scan_engine import _slices
from commefficient_tpu_torch.telemetry import RetraceError, RetraceSentinel
from commefficient_tpu_torch.telemetry.capture import describe_signature
from commefficient_tpu_torch.train.cv_train import _CvHooks
from commefficient_tpu_torch.train.runner import run_train_loop
from commefficient_tpu_torch.utils.checkpoint import FedCheckpointer
from commefficient_tpu_torch.utils.config import Config
from commefficient_tpu_torch.utils.logging import MetricsWriter
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

ONE = {**BASE, "num_devices": 1}
# the reference's _cfg (tests/test_scan_engine.py) at one device
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=40, num_rows=3, num_cols=256, topk_method="threshold")
# the main path's decode: the exact top-k (topk_sparsify, nonzero)
EXACT = {**SKETCH, "topk_method": "exact"}
CASES = {
    "exact": EXACT,
    "threshold": SKETCH,
    "sharded": {**SKETCH, "sketch_decode": "sharded"},
    "fedsim": {**EXACT, "availability": "bernoulli", "dropout_prob": 0.3,
               "chaos": "straggler@0.2"},
    "dp": {**EXACT, "max_grad_norm": 1.0, "dp_noise_multiplier": 0.5},
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=30),
    # powersgd without the warm start: a fresh Q a round, drawn on the
    # host from the round and staged with the epoch's inputs
    "powersgd_cold": dict(mode="powersgd", error_type="virtual",
                          virtual_momentum=0.9, powersgd_rank=2,
                          powersgd_warm_start=False),
    # the rest of the round family
    "uncompressed": dict(mode="uncompressed"),
    "fedavg": dict(mode="fedavg", error_type="none", num_local_iters=2),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9, k=40),
    "true_topk_down": dict(mode="true_topk", error_type="virtual",
                           virtual_momentum=0.9, k=40, do_topk_down=True),
    # the sketch-fused backward: K1's segment form inside the block
    "fused": {**EXACT, "fuse_clients": True, "sketch_fused_bwd": True},
    "fused_layerwise": {**EXACT, "fuse_clients": True,
                        "sketch_fused_bwd": True,
                        "overlap_collectives": "layerwise"},
    # the decode in two slices of the coordinates (K4's range form)
    "blocks2": {**EXACT, "num_blocks": 2},
    "blocks2_sharded": {**SKETCH, "sketch_decode": "sharded",
                        "num_blocks": 2},
    # resilience/'s skip_clients blacklist composed into the staged envs
    "skip_clients": {**EXACT, "availability": "bernoulli",
                     "dropout_prob": 0.3, "recover_policy": "skip_clients",
                     "blacklist": (1, 6)},
}
LEAVES = ("params_vec", "momentum", "error", "client_vel", "client_err",
          "comp")
N = 7


def _lr_fn(s):
    return 0.3 - 0.01 * s


@pytest.fixture(scope="module")
def data():
    ds, params, _ = _setup(BASE["num_clients"])
    return ds, to_numpy_tree(jax.tree.map(np.asarray, params))


def _build(data, blacklist=None, **kw):
    cfg = Config(**{**ONE, **kw, "device": "cpu"})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, data[1],
                                classification_loss(torch_tinymlp))
    if blacklist is not None:
        sess.blacklist_clients(np.asarray(blacklist))
    ds = FedDataset(data[0].data, cfg.num_clients, iid=True, seed=0)
    sampler = FedSampler(ds, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size, seed=1)
    assert sess.maybe_attach_data(ds, sampler)
    return sess, sampler


def _per_round(sess, sampler, n):
    out = []
    for r in range(n):
        ids, idx, plan = sampler.sample_round_indices(r)
        out.append(sess.train_round_indices(ids, idx, plan, _lr_fn(r)))
    return out


def _scan(data, K, n=N, **kw):
    sess, sampler = _build(data, scan_rounds=K, **kw)
    eng = ScanRounds(sess.cfg, sess, sampler, _lr_fn, num_rounds=n,
                     steps_per_epoch=n).start(0)
    out = list(eng.epoch_rounds(0, 0, n))
    return sess, eng, out


def _leaves_equal(a, b):
    for leaf in LEAVES:
        x, y = getattr(a.state, leaf), getattr(b.state, leaf)
        assert (x is None) == (y is None), leaf
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), leaf
    assert a.state.step == b.state.step


def _host(m):
    return {k: float(v) for k, v in m.items()
            if not k.startswith(("pipeline/", "trace/"))}


# -- the port against itself ---------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_engine_bit_exact_vs_per_round_dispatch(data, case):
    """K = 3 over 7 rounds (blocks 3, 3, 1): every state leaf and every
    round's scalars (losses, ``diag/*``, ``fedsim/*``, ``xla/retraces``)
    equal to the per-round path's, each round named with its block
    length."""
    kw = {**CASES[case], "telemetry_level": 1}
    sess_a, sampler_a = _build(data, **kw)
    want = [_host(m) for m in _per_round(sess_a, sampler_a, N)]
    sess_b, eng, out = _scan(data, 3, **kw)
    assert [s for s, _, _, _, _ in out] == list(range(N))
    _leaves_equal(sess_a, sess_b)
    assert [_host(m) for _, _, m, _, _ in out] == want
    assert [m["pipeline/scan_rounds_per_dispatch"] for _, _, m, _, _ in
            out] == [3.0] * 6 + [1.0]
    st = eng.stats()
    assert (st["dispatches"], st["rounds"], st["block_lengths"]) == (
        3, N, [1, 3])
    assert st["captures"] == 0 and st["replays"] == 0  # the CPU's loop
    assert sess_b.retrace_sentinel.retraces == 0
    assert [lr for _, lr, _, _, _ in out] == [float(_lr_fn(s))
                                              for s in range(N)]


def _runner(data, tmp_path, tag, **kw):
    """``run_train_loop`` at level 1 with a metrics writer: (session, run
    dir, engine stats)."""
    sess, sampler = _build(data, **{
        **EXACT, "telemetry_level": 1, "perf_audit": False,
        "num_epochs": 1, "pivot_epoch": 1, "lr_scale": 0.1,
        "local_batch_size": 8, **kw})
    run_dir = str(tmp_path / f"run{tag}")
    writer = MetricsWriter(run_dir, cfg=sess.cfg)
    x, y = data[0].data["x"][:40], data[0].data["y"][:40]
    hooks = _CvHooks(sess, FedDataset({"x": x, "y": y}, 1, seed=0), 32)
    stats = {}
    try:
        run_train_loop(sess.cfg, sess, sampler, hooks, writer=writer,
                       engine_stats=stats)
    finally:
        writer.close()
    return sess, run_dir, stats


def _scalars(run_dir, since=0,
             drop=("pipeline/", "trace/", "xla/exposed_collective_ms",
                   "resilience/")):
    """metrics.jsonl as (name, value, step) from step ``since``, the last
    of each (name, step) (a recovery writes its replayed rounds again)."""
    rows = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if ("name" not in rec or rec["name"].startswith(drop)
                    or rec["step"] < since):
                continue
            rows[(rec["name"], rec["step"])] = (rec["name"], rec["value"],
                                                rec["step"])
    return list(rows.values())


def test_runner_scan_bit_exact_and_resume(data, tmp_path):
    """9 rounds, checkpoint every 5, K = 4 (blocks 4, 1, 4): params and the
    drained scalars equal to the per-round run; resumed from the round-5
    checkpoint the scan run ends where the unbroken one ends, with the
    same tail."""
    ck = dict(checkpoint_every=5)
    s0, d0, _ = _runner(data, tmp_path, "0", scan_rounds=0,
                        checkpoint_dir=str(tmp_path / "c0"), **ck)
    s4, d4, st = _runner(data, tmp_path, "4", scan_rounds=4,
                         checkpoint_dir=str(tmp_path / "c4"), **ck)
    _leaves_equal(s0, s4)
    assert _scalars(d0) and _scalars(d0) == _scalars(d4)
    assert st["dispatches"] == 3 and st["rounds"] == 9
    FedCheckpointer(s4.cfg).discard_steps_after(5)
    sr, dr, st = _runner(data, tmp_path, "4r", scan_rounds=4, resume=True,
                         checkpoint_dir=str(tmp_path / "c4"), **ck)
    _leaves_equal(s0, sr)
    drop = ("pipeline/", "trace/", "xla/exposed_collective_ms", "comm/")
    assert _scalars(dr, 5, drop) == _scalars(d0, 5, drop)
    assert st["rounds"] == 4 and sr.retrace_sentinel.retraces == 0


def test_runner_scan_retry_recovery_bit_exact(data, tmp_path):
    """A NaN client at round 5 under ``retry`` (snapshots every 4): the
    scan run rolls back to round 4, replays, and ends bit-equal to the
    per-round run with the same fault, its healed scalars equal."""
    kw = dict(availability="bernoulli", dropout_prob=0.25,
              chaos="nan_client@1:rounds=5-5", recover_policy="retry",
              snapshot_every=4)
    s0, d0, _ = _runner(data, tmp_path, "p", scan_rounds=0, **kw)
    s3, d3, st = _runner(data, tmp_path, "s", scan_rounds=3, **kw)
    _leaves_equal(s0, s3)
    assert _scalars(d0) == _scalars(d3)
    assert st["restarts"] == 1 and s3.retrace_sentinel.retraces == 0
    assert s3.resilience.manager.recoveries == 1


def test_device_env_round_equals_host_env_round_all_dropped_included(data):
    """The raw index round on a ``DeviceEnv`` (the live scale an f32
    tensor divided by a tensor, the empty round's hold by ``torch.where``)
    gives the host ``RoundEnv`` round's bits: all live, all dropped (the
    update zeroed, the server leaves held) and a partial cohort."""
    kw = {**EXACT, "availability": "bernoulli", "dropout_prob": 0.3,
          "telemetry_level": 1}
    (a, sampler), (b, _) = _build(data, **kw), _build(data, **kw)
    raw = b.raw_round_idx_fn()
    for r, live in enumerate(([1] * 8, [0] * 8, [1, 0, 1, 1, 0, 1, 1, 1])):
        env = a.fedsim_round_env(r)._replace(
            live=np.asarray(live, np.float32),
            corrupt=np.zeros(8, np.float32), live_count=np.float32(sum(live)))
        ids, idx, plan = sampler.sample_round_indices(r)
        want = a.train_round_indices(ids, idx, plan, _lr_fn(r), env=env)
        b.state, got = raw(
            b.state, torch.from_numpy(ids.astype(np.int64)),
            torch.from_numpy(idx), tuple(torch.from_numpy(p) for p in plan),
            torch.tensor(np.float32(_lr_fn(r))), env=DeviceEnv(
                torch.from_numpy(env.live), torch.from_numpy(env.corrupt),
                torch.tensor(env.live_count)))
        assert {k: float(v) for k, v in got.items()} == {
            k: float(want[k]) for k in got}, r
        _leaves_equal(a, b)


# -- the port against the reference ------------------------------------------------


def test_scan_engine_matches_the_reference_scan_engine(data):
    """The reference's ``ScanRounds`` and the port's on the same config,
    seed and sampler (K = 3, 7 rounds, level 1)."""
    kw = {**SKETCH, "scan_rounds": 3, "telemetry_level": 1}
    ref_cfg = RefConfig(**{**ONE, **kw})
    ds, params, loss_fn = _setup(ref_cfg.num_clients)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_sess = RefSession(ref_cfg, params, loss_fn)
    ref_sampler = RefSampler(ds, num_workers=ref_cfg.num_workers,
                             local_batch_size=ref_cfg.local_batch_size, seed=1)
    assert ref_sess.maybe_attach_data(ds, ref_sampler)
    ref_eng = RefScan(ref_cfg, ref_sess, ref_sampler, _lr_fn, num_rounds=N,
                      steps_per_epoch=N).start(0)
    ref_out = list(ref_eng.epoch_rounds(0, 0))
    sess, eng, out = _scan(data, 3, **{k: v for k, v in kw.items()
                                       if k != "scan_rounds"})
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref_sess.state.params_vec),
                               rtol=1e-4, atol=1e-5)
    for leaf in ("momentum", "error"):
        want = np.asarray(getattr(ref_sess.state, leaf))
        np.testing.assert_allclose(getattr(sess.state, leaf).numpy(), want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(
        [float(m["loss"]) for _, _, m, _, _ in out],
        [float(np.asarray(m["loss"])) for _, _, m in ref_out], rtol=1e-4)
    assert ([m["pipeline/scan_rounds_per_dispatch"] for _, _, m, _, _ in out]
            == [float(m["pipeline/scan_rounds_per_dispatch"])
                for _, _, m in ref_out])
    assert eng.stats()["dispatches"] == ref_eng.stats()["dispatches"]


# -- powersgd without the warm start (ROADMAP C.8) ---------------------------------

COLD = CASES["powersgd_cold"]
N_COLD = 10  # K = 4: blocks 4, 4, 2


def test_scan_powersgd_cold_start_bit_exact_vs_per_round_dispatch(data):
    """``--scan_rounds 4`` over 10 rounds of powersgd without the warm
    start: every leaf and every drained scalar equal to the per-round
    path's, the Qs staged with the epoch's inputs."""
    kw = {**COLD, "telemetry_level": 1}
    sess_a, sampler_a = _build(data, **kw)
    want = [_host(m) for m in _per_round(sess_a, sampler_a, N_COLD)]
    sess_b, eng, out = _scan(data, 4, n=N_COLD, **kw)
    _leaves_equal(sess_a, sess_b)
    assert sess_b.state.comp is None  # nothing carried across rounds
    assert [_host(m) for _, _, m, _, _ in out] == want
    st = eng.stats()
    assert (st["dispatches"], st["block_lengths"]) == (3, [2, 4])
    assert sess_b.retrace_sentinel.retraces == 0


def test_scan_powersgd_cold_start_block_rounds_use_their_own_q(data,
                                                                monkeypatch):
    """Inside one block each round's server step reads its own staged Q,
    the per-round path's ``_fresh_q(step)``: two rounds of a block use
    different Qs, and no Q is drawn inside the block."""
    from commefficient_tpu_torch.compress.powersgd import PowerSGDCompressor

    seen, drawn = [], []
    server_update = PowerSGDCompressor.server_update
    fresh_q = PowerSGDCompressor._fresh_q

    def spy(self, *a, draw=None, **k):
        seen.append((a[-1], draw))
        return server_update(self, *a, draw=draw, **k)

    def spy_fresh(self, step, device):
        drawn.append(step)
        return fresh_q(self, step, device)

    monkeypatch.setattr(PowerSGDCompressor, "server_update", spy)
    monkeypatch.setattr(PowerSGDCompressor, "_fresh_q", spy_fresh)
    sess, eng, _ = _scan(data, 4, n=4, **COLD)
    assert eng.stats()["dispatches"] == 1  # one block of 4
    assert drawn == [0, 1, 2, 3]  # all staged before the block
    assert [step for step, _ in seen] == [0, 1, 2, 3]
    qs = [q for _, q in seen]
    assert all(q is not None for q in qs)
    for step, q in enumerate(qs):
        assert torch.equal(q, fresh_q(sess.compressor, step, "cpu"))
    assert not torch.equal(qs[0], qs[1])


def test_scan_powersgd_cold_start_matches_the_reference_scan_engine(
        data, monkeypatch):
    """The reference's ``ScanRounds`` and the port's on powersgd without
    the warm start (K = 4, 10 rounds, level 1), the port's ``_fresh_q``
    returning the reference's Q of each step (JAX's PRNG draws other
    numbers: ROADMAP C.7.4)."""
    from commefficient_tpu_torch.compress.powersgd import PowerSGDCompressor

    kw = {**COLD, "scan_rounds": 4, "telemetry_level": 1}
    ref_cfg = RefConfig(**{**ONE, **kw})
    ds, params, loss_fn = _setup(ref_cfg.num_clients)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_sess = RefSession(ref_cfg, params, loss_fn)
    ref_sampler = RefSampler(ds, num_workers=ref_cfg.num_workers,
                             local_batch_size=ref_cfg.local_batch_size, seed=1)
    assert ref_sess.maybe_attach_data(ds, ref_sampler)
    ref_eng = RefScan(ref_cfg, ref_sess, ref_sampler, _lr_fn,
                      num_rounds=N_COLD, steps_per_epoch=N_COLD).start(0)
    ref_out = list(ref_eng.epoch_rounds(0, 0))
    ref_q = {s: np.array(ref_sess.compressor._fresh_q(s))
             for s in range(N_COLD)}
    monkeypatch.setattr(
        PowerSGDCompressor, "_fresh_q",
        lambda self, step, device: torch.from_numpy(ref_q[int(step)]).to(
            device))
    sess, eng, out = _scan(data, 4, n=N_COLD, **{
        k: v for k, v in kw.items() if k != "scan_rounds"})
    np.testing.assert_allclose(sess.state.params_vec.numpy(),
                               np.asarray(ref_sess.state.params_vec),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        [float(m["loss"]) for _, _, m, _, _ in out],
        [float(np.asarray(m["loss"])) for _, _, m in ref_out], rtol=1e-4)
    assert eng.stats()["dispatches"] == ref_eng.stats()["dispatches"]


def _plan_stub(cls, K, ckpt, snap):
    """An engine of ``cls`` holding only what ``_blocks`` reads."""
    stub = types.SimpleNamespace(K=K, cfg=types.SimpleNamespace(
        checkpoint_every=ckpt, checkpoint_dir="d" if ckpt else "",
        recovery_enabled=snap > 0, snapshot_every=snap))
    stub._boundaries = lambda: cls._boundaries(stub)
    return stub


def test_block_plan_equals_the_reference():
    for K in (2, 3, 4, 8):
        for ckpt in (0, 3, 5):
            for snap in (0, 4, 7):
                port = _plan_stub(ScanRounds, K, ckpt, snap)
                ref = _plan_stub(RefScan, K, ckpt, snap)
                for start in (0, 3, 9):
                    for stop in (start + 1, start + 10, start + 23):
                        got = list(ScanRounds._blocks(port, start, stop))
                        assert got == list(RefScan._blocks(ref, start, stop))
                        assert sum(n for _, n in got) == stop - start
    assert list(ScanRounds._blocks(_plan_stub(ScanRounds, 4, 5, 0), 0, 10)) \
        == [(0, 4), (4, 1), (5, 4), (9, 1)]


@pytest.mark.parametrize("kw,needle", [
    (dict(device_data=False), "device-resident"),
    (dict(control_policy="fixed", control_schedule="0-=0",
          ladder="k=40,20"), "control"),
    (dict(pipeline_depth=2), "pipeline_depth"),
    (dict(preempt_signals=True), "preempt"),
    (dict(chaos="preempt@3"), "preempt"),
    (dict(fsdp=True), "index path"),
    (dict(chaos="resize@4:rounds=3-"), "fleet"),
    (dict(async_buffer=4, fuse_clients=False), "async"),
    (dict(max_retraces=-1), "max_retraces"),
    (dict(scan_rounds=-1), "scan_rounds"),
])
def test_scan_rounds_incompatible_knobs_refused(kw, needle):
    base = {**BASE, **SKETCH, "scan_rounds": 4, "telemetry_level": 1, **kw}
    with pytest.raises(ValueError, match=needle) as port:
        Config(**base)
    with pytest.raises(ValueError) as ref:
        RefConfig(**base)
    assert str(port.value) == str(ref.value)


def test_config_accepts_scan_rounds_and_max_retraces_as_the_reference():
    for kw in (dict(scan_rounds=4), dict(scan_rounds=1), dict(max_retraces=0),
               dict(scan_rounds=8, max_retraces=2, telemetry_level=1)):
        cfg, ref = Config(**{**BASE, **SKETCH, **kw}), \
            RefConfig(**{**BASE, **SKETCH, **kw})
        assert (cfg.scan_rounds, cfg.max_retraces) == (ref.scan_rounds,
                                                       ref.max_retraces)


def test_scan_engine_refuses_session_without_device_data(data):
    cfg = Config(**{**ONE, **SKETCH, "scan_rounds": 3, "device": "cpu"})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, data[1],
                                classification_loss(torch_tinymlp))
    sampler = FedSampler(FedDataset(data[0].data, 12, iid=True, seed=0),
                         num_workers=8, local_batch_size=4, seed=1)
    with pytest.raises(ValueError, match="device-resident"):
        ScanRounds(cfg, sess, sampler, _lr_fn, num_rounds=5,
                   steps_per_epoch=5)


# -- the retrace sentinel -------------------------------------------------------------


def test_sentinel_counts_a_second_capture_and_names_the_diff():
    """The port's sentinel counts as the reference's does (``traces - 1``
    a stream) and raises over ``max_retraces`` naming the changed leaf."""
    a = describe_signature((torch.zeros(4), {"lr": torch.zeros(())}),
                           {"L": 3})
    b = describe_signature((torch.zeros(4), {"lr": torch.zeros((),
                                             dtype=torch.float64)}), {"L": 3})
    port, ref = RetraceSentinel(), RefSentinel()
    for sig in (a, a, b):
        port.note("round_scan_fn[x3]", sig)
        ref.signatures.setdefault("round_scan_fn[x3]", []).append(sig)
    port.note("round_scan_fn[x1]", a)
    ref.signatures.setdefault("round_scan_fn[x1]", []).append(a)
    assert (port.traces, port.retraces) == (ref.traces, ref.retraces) == (4,
                                                                          2)
    strict = RetraceSentinel(max_retraces=0)
    strict.note("round_scan_fn[x3]", a)
    with pytest.raises(RetraceError, match=r"(?s)round_scan_fn\[x3\].*"
                       r"float32\[\]@cpu -> float64\[\]@cpu"):
        strict.note("round_scan_fn[x3]", b)


def test_engine_recaptures_on_a_changed_signature_under_max_retraces(data):
    """The engine's program of a length is kept while the signature holds;
    a staged input of another dtype is a re-capture, counted, and with
    ``max_retraces=0`` a ``RetraceError`` naming the leaf."""
    sess, eng, _ = _scan(data, 3, **EXACT)
    staged, _, _ = eng._stage_range(0, 3)
    prog = eng._program(3, staged)
    assert eng._program(3, staged) is prog
    staged64 = {**staged, "lr": staged["lr"].to(torch.float64)}
    assert eng._program(3, staged64) is not prog
    assert sess.retrace_sentinel.retraces == 1
    sess, eng, _ = _scan(data, 3, max_retraces=0, **EXACT)
    staged, _, _ = eng._stage_range(0, 3)
    with pytest.raises(RetraceError, match=r"\['lr'\]: float32\[3\]@cpu -> "
                                           r"float64\[3\]@cpu"):
        eng._program(3, {**staged, "lr": staged["lr"].to(torch.float64)})


def test_xla_retraces_rides_both_paths_at_level_1(data):
    sess, sampler = _build(data, telemetry_level=1, **EXACT)
    m = _per_round(sess, sampler, 1)[0]
    assert m["xla/retraces"] == 0.0
    _, _, out = _scan(data, 3, n=3, telemetry_level=1, **EXACT)
    assert all(m["xla/retraces"] == 0.0 for _, _, m, _, _ in out)
    sess, sampler = _build(data, telemetry_level=0, **EXACT)
    assert "xla/retraces" not in _per_round(sess, sampler, 1)[0]


# -- the capturable round ---------------------------------------------------------------


def test_captured_topk_equals_topk_sparsify_ties_included():
    rng = np.random.default_rng(0)
    for trial in range(300):
        n = int(rng.integers(2, 400))
        k = int(rng.integers(1, n + 1))
        # small integers: many ties at the k-th magnitude
        v = (rng.integers(-5, 6, size=n) * (0.25 + trial % 3)).astype(
            np.float32)
        t = torch.from_numpy(v)
        vals, idx = topk_sparsify(t, k)
        svals, sidx = topk_static(t, k)
        assert idx.numel() == k
        assert torch.equal(sidx, idx) and torch.equal(svals, vals), (v, k)
        assert torch.equal(topk_scatter(t, k), topk_dense(t, k))


class _NoReadBack(TorchDispatchMode):
    """Raises on any op that reads a device value back to the host, sizes
    a tensor by the data, or makes a tensor from host data (``lift_fresh``:
    on the card a copy from host memory, which a graph would freeze)."""

    BANNED = ("aten._local_scalar_dense", "aten.nonzero", "aten.item",
              "aten.is_nonzero", "aten.masked_select", "aten.unique",
              "aten.lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith(self.BANNED):
            raise AssertionError(f"{name} inside the block program")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_program_reads_nothing_back(data, case, monkeypatch):
    """The block program, with the selections in their capture forms (as
    under ``torch.cuda.graph``), runs no op that reads back to the host or
    sizes by the data, and gives the per-round path's bits."""
    kw = {**CASES[case], "telemetry_level": 1}
    sess_a, sampler_a = _build(data, **kw)
    _per_round(sess_a, sampler_a, 3)
    sess, sampler = _build(data, scan_rounds=3, **kw)
    eng = ScanRounds(sess.cfg, sess, sampler, _lr_fn, num_rounds=3,
                     steps_per_epoch=3)
    staged, cids, _ = eng._stage_range(0, 3)
    if eng._dp:
        staged["noise"] = eng._noise(0, cids)
    monkeypatch.setattr(topk_mod, "graph_capturing", lambda t: True)
    with _NoReadBack():
        state, packs = eng._block_fn(3)(sess.state, staged)
    sess.state = state
    _leaves_equal(sess_a, sess)
    assert set(packs) >= {"loss", "diag/nonfinite"}


def test_cifar_block_reads_nothing_back_and_cv_train_scans(tmp_path,
                                                           monkeypatch):
    """The main path's own pieces on the CIFAR-10 layout: uint8 images on
    the device, the augment plan applied there and the normalizer in the
    loss, a narrow ResNet-9. The block program holds no host read-back
    and no host data (the augment's fill and the normalizer's constants
    live on the device), and ``cv_train.main --scan_rounds 3
    --max_retraces 0`` trains the per-round run's params bit for bit and
    writes a run dir the reference's checker passes."""
    import importlib.util
    from pathlib import Path

    from commefficient_tpu_torch.train import cv_train
    from commefficient_tpu_torch.utils.config import parse_args
    from test_torch_round import _write_cifar_pickles

    _write_cifar_pickles(str(tmp_path), n_per_batch=16)
    flags = ["--mode", "sketch", "--k", "200", "--num_rows", "3",
             "--num_cols", "2000", "--virtual_momentum", "0.9",
             "--error_type", "virtual", "--num_workers", "4",
             "--num_clients", "8", "--local_batch_size", "4",
             "--num_epochs", "1", "--telemetry_level", "1", "--device",
             "cpu", "--dataset_dir", str(tmp_path)]
    cfg = parse_args(flags + ["--scan_rounds", "3"])
    train, _, _, params, loss_fn, augment = cv_train.build_model_and_data(
        cfg, width=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sess = FederatedSession(cfg, params, loss_fn)
    sampler = FedSampler(train, num_workers=4, local_batch_size=4,
                         seed=cfg.seed, augment=augment)
    assert sess.maybe_attach_data(train, sampler, augment)
    assert sess.dev_data["x"].dtype == torch.uint8 and augment is not None
    eng = ScanRounds(cfg, sess, sampler, _lr_fn, num_rounds=3,
                     steps_per_epoch=3)
    staged, _, _ = eng._stage_range(0, 3)
    # the engine's warm-up round on scratch state (on the card it runs
    # before the first capture): the device constants are made here
    scratch = dataclasses.replace(sess.state, params_vec=sess.state.params_vec
                                  .clone())
    eng._block_fn(1)(scratch, _slices(staged, 0, 1))
    monkeypatch.setattr(topk_mod, "graph_capturing", lambda t: True)
    with _NoReadBack():
        eng._block_fn(3)(sess.state, staged)
    monkeypatch.undo()

    outs = {}
    for k in (0, 3):
        outs[k] = cv_train.main(flags + [
            "--scan_rounds", str(k), "--max_retraces", "0", "--logdir",
            str(tmp_path / f"runs{k}"), "--checkpoint_dir",
            str(tmp_path / f"ck{k}")], model_kw={"width": 4})
    assert outs[3]["pipeline_stats"]["rounds_per_dispatch"] > 1
    assert [h["loss"] for h in outs[3]["history"]] == [
        h["loss"] for h in outs[0]["history"]]
    a, b = (torch.load(tmp_path / f"ck{k}" / f"step_{outs[k]['final_step']}"
                       ".pt", weights_only=True)["fed_state"] for k in (0, 3))
    for leaf in ("params_vec", "momentum", "error"):
        assert torch.equal(a[leaf], b[leaf]), leaf
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema",
        Path(__file__).resolve().parents[1] / "scripts"
        / "check_telemetry_schema.py")
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    checker.validate_run_dir(outs[3]["logdir"])

"""The port's round pipeline on the CPU (counterparts of the reference's
tests/test_pipeline.py), at tests/test_round.py's TinyMLP size.

``pipeline_depth 2`` realizes and stages rounds on a worker thread (on the
CPU the staging is the identity), and the runner's depth-0 source reads the
sampler's epoch through ``data/sampler.py::prefetch``; every input is a pure
function of the round, so both must train what the per-round loop trains,
bit for bit: params, every ``FedState`` leaf and the drained losses, for
sketch, local_topk and fedavg, under fedsim masking, on the index path
(the training set attached), and across a checkpoint resume. The
prefetcher's contracts: the synchronous realization, in-order delivery,
exhaustion, a worker fault re-raised with its own traceback, and a join
with a full window. The deferred drain's history holds the losses a
per-round read-back gives.
"""

import threading
import time
import traceback

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.pipeline import (
    PipelinedRounds,
    PrefetchWorkerDied,
    RoundPrefetcher,
)
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.config import Config
from commefficient_tpu_torch.utils.schedule import piecewise_linear_lr
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

# 600 rows at 8 clients x 16: 4 rounds an epoch (fedavg's 2 x 16: 2), so
# ROUNDS crosses epoch ends, where the drain and the prefetch thread turn
ONE = {**BASE, "num_devices": 1, "local_batch_size": 16, "num_epochs": 4}
LEAVES = ("params_vec", "momentum", "error", "client_vel", "client_err",
          "comp")
CASES = {
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=40, num_rows=3, num_cols=512),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=30),
    "fedavg": dict(mode="fedavg", error_type="none", num_local_iters=2),
    "fedsim": dict(mode="local_topk", error_type="local", local_momentum=0.9,
                   k=30, availability="bernoulli", dropout_prob=0.4,
                   chaos="straggler@0.2"),
}
ROUNDS = 8


@pytest.fixture(scope="module")
def setup():
    ds, params, _ = _setup(BASE["num_clients"])
    return (FedDataset(ds.data, BASE["num_clients"], iid=True, seed=0),
            to_numpy_tree(jax.tree.map(np.asarray, params)))


class _Hooks(WorkloadHooks):
    def new_accumulator(self):
        return {"loss": []}

    def accumulate(self, acc, loss, metrics):
        acc["loss"].append(loss)

    def evaluate(self):
        return {"loss": 0.0}

    def epoch_row(self, **kw):
        return {"epoch": kw["epoch"]}


def _session(setup, cfg):
    return FederatedSession(cfg, setup[1], classification_loss(torch_tinymlp))


def _sampler(setup, cfg):
    return FedSampler(setup[0], num_workers=cfg.num_workers,
                      local_batch_size=cfg.sampler_batch_size, seed=1)


def _run(setup, attach=False, **kw):
    """(session, history) of ``run_train_loop`` over ``kw``'s config."""
    cfg = Config(**{**ONE, "device": "cpu",
                    "max_rounds": ROUNDS, "device_data": attach, **kw})
    sess, sampler = _session(setup, cfg), _sampler(setup, cfg)
    assert sess.maybe_attach_data(setup[0], sampler) == attach
    _, hist, _ = run_train_loop(cfg, sess, sampler, _Hooks())
    return sess, hist


def _assert_states_equal(a, b):
    for leaf in LEAVES:
        x, y = getattr(a.state, leaf), getattr(b.state, leaf)
        assert (x is None) == (y is None), leaf
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), leaf
    assert a.state.step == b.state.step


def _losses(hist):
    return [h["loss"] for h in hist]


@pytest.mark.parametrize("attach", [False, True], ids=["host", "index"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_depth2_is_bit_exact_against_depth0(setup, name, attach):
    """Params, every state leaf and the drained losses, depth 2 against
    depth 0, on the host batch path and on the index path."""
    kw = CASES[name]
    sync, h0 = _run(setup, attach, **kw)
    piped, h2 = _run(setup, attach, pipeline_depth=2, **kw)
    assert [h["step"] for h in h2] == list(range(ROUNDS))
    assert _losses(h2) == _losses(h0)
    _assert_states_equal(sync, piped)
    if name == "fedsim":
        assert [h["fedsim/participation_rate"] for h in h2] == [
            h["fedsim/participation_rate"] for h in h0]


def test_deferred_drain_equals_per_round_readback(setup):
    """The runner reads no loss back until a drain; its history equals the
    losses a loop that reads each round's loss back at once gets, and each
    row's ``ms`` and ``data_ms`` are set."""
    cfg = Config(**ONE, **CASES["sketch"], device="cpu")
    sess, sampler = _session(setup, cfg), _sampler(setup, cfg)
    spe = sampler.steps_per_epoch()
    lr_fn = lambda s: piecewise_linear_lr(  # noqa: E731
        s, steps_per_epoch=spe, pivot_epoch=cfg.pivot_epoch,
        num_epochs=cfg.num_epochs, lr_scale=cfg.lr_scale)
    want = []
    for s in range(ROUNDS):
        ids, batch = sampler.sample_round(s)
        m = sess.train_round(ids, microbatched(cfg, batch), float(lr_fn(s)))
        want.append(float(m["loss"]))
    reported = []
    cfg2 = cfg.replace(max_rounds=ROUNDS)
    runner_sess = _session(setup, cfg2)
    _, hist, _ = run_train_loop(cfg2, runner_sess, _sampler(setup, cfg2),
                                _Hooks(), on_round=reported.append)
    assert _losses(hist) == want
    assert reported == hist  # every row once, in step order
    assert all(h["ms"] > 0 and h["data_ms"] >= 0 for h in hist)
    _assert_states_equal(sess, runner_sess)


@pytest.mark.parametrize("depth", [0, 2])
def test_pipelined_resume_is_bit_exact(setup, tmp_path, depth):
    """Kill at round 3 (a save every 2 and the forced end save), resume to
    ROUNDS at the same depth: equal to ROUNDS straight at depth 0."""
    kw = dict(CASES["fedsim"], pipeline_depth=depth)
    straight, hist = _run(setup, **CASES["fedsim"])
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    _run(setup, **{**kw, **ck, "max_rounds": 3})
    resumed, hist2 = _run(setup, resume=True, **{**kw, **ck})
    assert [h["step"] for h in hist2] == list(range(3, ROUNDS))
    assert _losses(hist2) == _losses(hist)[3:]
    _assert_states_equal(straight, resumed)


def _prefetcher(setup, depth=2, start=0, stop=ROUNDS, sampler=None,
                **cfg_kw):
    cfg = Config(**ONE, **{**CASES["fedsim"], **cfg_kw}, device="cpu")
    sess = _session(setup, cfg)
    sampler = sampler or _sampler(setup, cfg)
    return sess, sampler, RoundPrefetcher(
        session=sess, sampler=sampler, lr_fn=lambda s: 0.1 + 0.01 * s,
        depth=depth, start_step=start, stop_step=stop)


def test_prefetcher_matches_synchronous_realization(setup):
    sess, sampler, pf = _prefetcher(setup, start=2, stop=6)
    try:
        pf.start()
        for s in range(2, 6):
            work = pf.get(s)
            ids, batch = sampler.sample_round(s)
            assert work.step == s and work.lr == 0.1 + 0.01 * s
            assert np.array_equal(work.client_ids, ids)
            assert work.idx is None and work.ready is None
            for k, v in batch.items():
                assert np.array_equal(work.batch[k], v), k
            env = sess.fedsim_env.round_env(s)
            assert np.array_equal(work.env.live, env.live)
            assert work.env.stats == env.stats
    finally:
        assert pf.close()


def test_prefetcher_in_order_contract_and_exhaustion(setup):
    _, _, pf = _prefetcher(setup, stop=2)
    try:
        pf.start()
        with pytest.raises(RuntimeError, match="order violated"):
            pf.get(1)  # round 0 is next
        assert pf.get(1).step == 1
        with pytest.raises(PrefetchWorkerDied, match="exhausted"):
            pf.get(2)
    finally:
        assert pf.close()
    with pytest.raises(RuntimeError, match="before start"):
        _prefetcher(setup)[2].get(0)


class _FailingSampler(FedSampler):
    """Raises in its draw of round ``bad``."""

    bad = 2

    def sample_round(self, round_idx, alloc=None):
        if round_idx == self.bad:
            self._corrupt_batch(round_idx)
        return super().sample_round(round_idx, alloc)

    def _corrupt_batch(self, round_idx):
        raise OSError(f"corrupt shard at round {round_idx}")


def test_worker_fault_surfaces_original_traceback(setup):
    """The worker's exception re-raises at the consuming round with the
    worker's frames, after the earlier rounds trained; the engine's worker
    is joined on the way out."""
    cfg = Config(**ONE, **CASES["sketch"], device="cpu",
                 max_rounds=ROUNDS, pipeline_depth=2)
    sess = _session(setup, cfg)
    sampler = _FailingSampler(setup[0], num_workers=8, local_batch_size=16,
                              seed=1)
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(OSError, match="corrupt shard at round 2") as ei:
        run_train_loop(cfg, sess, sampler, _Hooks())
    frames = [f.name for f in traceback.extract_tb(ei.value.__traceback__)]
    assert "_corrupt_batch" in frames and "_realize" in frames
    assert sess.state.step == 2
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.name == "round-prefetch"]


def test_depth0_prefetch_fault_reaches_the_loop(setup):
    """At depth 0 the sampler's prefetch thread re-raises a draw's fault in
    the runner, after the rounds before it."""
    cfg = Config(**ONE, **CASES["sketch"], device="cpu",
                 max_rounds=ROUNDS)
    sess = _session(setup, cfg)
    sampler = _FailingSampler(setup[0], num_workers=8, local_batch_size=16,
                              seed=1)
    with pytest.raises(OSError, match="corrupt shard at round 2"):
        run_train_loop(cfg, sess, sampler, _Hooks())
    assert sess.state.step == 2


def test_shutdown_joins_with_a_full_window(setup):
    _, _, pf = _prefetcher(setup, depth=2, stop=ROUNDS)
    pf.start()
    deadline = time.monotonic() + 30
    while pf.staged_rounds < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf.staged_rounds == 2  # the window is full; the worker blocks
    t0 = time.monotonic()
    assert pf.close()
    assert time.monotonic() - t0 < 5
    assert not pf._thread.is_alive()


def test_engine_stats_and_refusal(setup):
    cfg = Config(**ONE, **CASES["sketch"], device="cpu", pipeline_depth=2)
    sess, sampler = _session(setup, cfg), _sampler(setup, cfg)
    eng = PipelinedRounds(cfg, sess, sampler, lambda s: 0.1, 4).start(0)
    try:
        rounds = list(eng.epoch_rounds(0, 0, 4))
    finally:
        eng.close()
    assert [r[0] for r in rounds] == [0, 1, 2, 3]
    st = eng.stats()
    assert st["rounds"] == 4 and 0 <= st["occupancy"] <= 1
    assert st["host_stall_ms"] >= 0 and st["prefetch_host_ms"] > 0
    with pytest.raises(ValueError, match="pipeline_depth >= 1"):
        PipelinedRounds(cfg.replace(pipeline_depth=0), sess, sampler,
                        lambda s: 0.1, 4)


def test_config_pipeline_checks_are_the_references():
    assert Config(pipeline_depth=2).pipeline_enabled
    assert not Config().pipeline_enabled
    for kw, msg in ((dict(pipeline_depth=-1), "must be >= 0"),
                    (dict(pipeline_depth=2, scan_rounds=4), "drop "
                     "pipeline_depth"),
                    (dict(pipeline_depth=1, chaos="resize@4:rounds=1-2"),
                     "fleet events are incompatible with pipeline_depth")):
        with pytest.raises(ValueError, match=msg):
            Config(**kw)


@pytest.mark.parametrize("depth", [0, 2])
def test_round_source_runs_what_the_runner_runs(setup, depth):
    """``runner.round_source`` (profile_round's timed rounds) over a range
    that crosses an epoch end gives the runner's rounds and losses."""
    from commefficient_tpu_torch.train.runner import round_source

    sync, hist = _run(setup, **CASES["sketch"])
    cfg = Config(**ONE, **CASES["sketch"], device="cpu", device_data=False,
                 pipeline_depth=depth)
    sess, sampler = _session(setup, cfg), _sampler(setup, cfg)
    lrs = {h["step"]: h["lr"] for h in hist}
    got = [(s, float(m["loss"])) for s, _, m, _, _ in round_source(
        cfg, sess, sampler, lambda s: lrs[s], 0, ROUNDS)]
    assert got == [(h["step"], h["loss"]) for h in hist]
    _assert_states_equal(sync, sess)

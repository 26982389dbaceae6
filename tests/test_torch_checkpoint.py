"""The port's checkpoint/resume (``utils/checkpoint.py``) on the CPU, at
tests/test_round.py's TinyMLP size.

Kill and resume must reproduce the unbroken run bit for bit, in every
``FedState`` leaf: for the reference's configurations of
tests/test_checkpoint.py (sketch with virtual error, local_topk with local
momentum and error, powersgd with its warm-start ``Q``; its
``offload_client_state`` case is ROADMAP A11), and with bf16 tables,
with fedsim (bernoulli participation and stragglers), and with DP noise.
The checkpointer is off without a directory; restore refuses another
model and another sketch layout; a corrupted file is rejected by its
manifest and restore falls back to the next older step; at most
``MAX_TO_KEEP`` steps are kept and a step on disk is not saved again. The
runner resumes by fast-forwarding to the restored round.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu_torch.data import FedDataset, FedSampler
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.checkpoint import (
    MAX_TO_KEEP,
    FedCheckpointer,
)
from commefficient_tpu_torch.utils.config import Config
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

ONE = {**BASE, "num_devices": 1}
LEAVES = ("params_vec", "momentum", "error", "client_vel", "client_err",
          "comp")
CASES = {
    # the reference's (tests/test_checkpoint.py)
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=40, num_rows=3, num_cols=512),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=30),
    "powersgd": dict(mode="powersgd", error_type="virtual",
                     virtual_momentum=0.9, powersgd_rank=2),
    # and the port's other state: bf16 tables, fedsim, DP
    "sketch_bf16_tables": dict(mode="sketch", error_type="virtual",
                               virtual_momentum=0.9, k=40, num_rows=3,
                               num_cols=512, sketch_table_dtype="bfloat16"),
    "fedsim_bernoulli": dict(mode="local_topk", error_type="local",
                             local_momentum=0.9, k=30,
                             availability="bernoulli", dropout_prob=0.4,
                             chaos="straggler@0.2"),
    "dp": dict(mode="uncompressed", virtual_momentum=0.9, max_grad_norm=0.5,
               dp_noise_multiplier=0.7),
}


@pytest.fixture(scope="module")
def setup():
    ds, params, _ = _setup(BASE["num_clients"])
    return ds, to_numpy_tree(jax.tree.map(np.asarray, params))


def _session(setup, cfg):
    return FederatedSession(cfg, setup[1], classification_loss(torch_tinymlp))


def _train(setup, sess, start, stop, ckpt=None):
    sampler = FedSampler(FedDataset(setup[0].data, BASE["num_clients"],
                                    iid=True, seed=0), num_workers=8,
                         local_batch_size=sess.cfg.sampler_batch_size, seed=1)
    for r in range(start, stop):
        ids, batch = sampler.sample_round(r)
        sess.train_round(ids, microbatched(sess.cfg, batch),
                         0.1 + 0.02 * r)  # a varying lr
        if ckpt is not None:
            ckpt.maybe_save(sess, r + 1)


def _assert_states_equal(a, b):
    for leaf in LEAVES:
        x, y = getattr(a.state, leaf), getattr(b.state, leaf)
        assert (x is None) == (y is None), leaf
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), leaf
    assert a.state.step == b.state.step


@pytest.mark.parametrize("name", sorted(CASES))
def test_kill_and_resume_reproduces_unbroken_run(setup, tmp_path, name):
    cfg = Config(**ONE, **CASES[name], device="cpu")
    straight = _session(setup, cfg)
    _train(setup, straight, 0, 8)

    ck_cfg = cfg.replace(checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=4)
    first = _session(setup, ck_cfg)
    ckpt = FedCheckpointer(ck_cfg)
    _train(setup, first, 0, 4, ckpt)
    assert ckpt.latest_step() == 4 and ckpt.last_bytes > 0
    del first  # the killed process

    resumed = _session(setup, ck_cfg)  # a fresh state
    assert FedCheckpointer(ck_cfg).restore(resumed) == 4
    _train(setup, resumed, 4, 8)
    _assert_states_equal(straight, resumed)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "ck"))


def test_checkpointer_disabled_without_dir():
    ck = FedCheckpointer(Config(**ONE, device="cpu"))
    assert not ck.enabled
    assert ck.restore(None) is None
    assert not ck.maybe_save(None, 10)
    assert not ck.will_save(10, force=True)


def _saved(setup, tmp_path, every=1, rounds=1, **kw):
    cfg = Config(**ONE, **{**CASES["sketch"], **kw}, device="cpu",
                 checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=every)
    sess = _session(setup, cfg)
    ck = FedCheckpointer(cfg)
    _train(setup, sess, 0, rounds, ck)
    return cfg, sess, ck


def test_restore_rejects_mismatched_model(setup, tmp_path):
    cfg, _, _ = _saved(setup, tmp_path, mode="uncompressed",
                       error_type="none")
    other = {"params": {"Dense_0": {"kernel": np.zeros((8, 4), np.float32),
                                    "bias": np.zeros(4, np.float32)}}}
    sess = FederatedSession(cfg, other, classification_loss(
        lambda p, x: x @ p["params"]["Dense_0"]["kernel"]))
    with pytest.raises(ValueError, match="grad_size"):
        FedCheckpointer(cfg).restore(sess)


def test_restore_refuses_mismatched_sketch_layout(setup, tmp_path):
    cfg, _, _ = _saved(setup, tmp_path, every=2, rounds=2)
    other = _session(setup, cfg)
    other.spec = dataclasses.replace(other.spec, scramble_block=16)
    with pytest.raises(ValueError, match="sketch layout"):
        FedCheckpointer(cfg).restore(other)
    assert FedCheckpointer(cfg).restore(_session(setup, cfg)) == 2


def test_corrupted_file_rejected_by_manifest_and_older_step_restored(
        setup, tmp_path):
    cfg, sess, ck = _saved(setup, tmp_path, rounds=3)
    assert ck.all_steps() == [1, 2, 3]
    path = ck.path(3)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert "sha256" in ck.verify_step(3)
    fresh = _session(setup, cfg)
    with pytest.warns(UserWarning, match="step 3 REJECTED"):
        assert FedCheckpointer(cfg).restore(fresh) == 2
    with pytest.raises(ValueError, match="integrity"):
        FedCheckpointer(cfg).restore(_session(setup, cfg), step=3)


def test_keeps_at_most_three_steps_and_never_resaves(setup, tmp_path):
    cfg, sess, ck = _saved(setup, tmp_path, rounds=5)
    assert ck.all_steps() == [3, 4, 5] and MAX_TO_KEEP == 3
    assert sorted(os.listdir(tmp_path / "ck" / "manifests")) == [
        "3.json", "4.json", "5.json"]
    assert not ck.maybe_save(sess, 5, force=True)  # already on disk
    assert ck.will_save(6) and not ck.will_save(0)


class _Hooks(WorkloadHooks):
    def new_accumulator(self):
        return {}

    def accumulate(self, acc, loss, metrics):
        pass

    def evaluate(self):
        return {"loss": 0.0}

    def epoch_row(self, **kw):
        return {"epoch": kw["epoch"]}


def test_runner_fast_forwards_and_saves(setup, tmp_path):
    """``run_train_loop``: 3 rounds with a save every 2 and the forced end
    save, then a fresh session resumed to 8 rounds, equals 8 rounds
    straight (fedsim on, so the masks must follow the restored round)."""
    base = dict(ONE, **CASES["fedsim_bernoulli"], num_epochs=2, device="cpu")
    ds = FedDataset(setup[0].data, BASE["num_clients"], iid=True, seed=0)

    def run(**kw):
        cfg = Config(**{**base, **kw})
        sess = _session(setup, cfg)
        sampler = FedSampler(ds, num_workers=8, local_batch_size=4, seed=1)
        _, hist, facts = run_train_loop(cfg, sess, sampler, _Hooks())
        return sess, hist, facts

    straight, hist, _ = run(max_rounds=8)
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    _, hist1, facts1 = run(max_rounds=3, **ck)
    assert [h["step"] for h in hist1] == [0, 1, 2]
    assert facts1["resumed_from"] == 0 and facts1["save_ms"] > 0
    assert FedCheckpointer(Config(**base, **ck)).all_steps() == [2, 3]
    resumed, hist2, facts2 = run(max_rounds=8, resume=True, **ck)
    assert facts2["resumed_from"] == 3 and facts2["restore_ms"] > 0
    assert [h["step"] for h in hist2] == list(range(3, 8))
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[3:]]
    _assert_states_equal(straight, resumed)


def test_resume_and_save_need_a_directory():
    for kw in (dict(resume=True), dict(checkpoint_every=2)):
        with pytest.raises(ValueError, match="checkpoint_dir"):
            Config(**kw)

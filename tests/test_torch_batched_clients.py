"""The batched client step (``parallel/round.py``'s
``batched_client_transmits``, one ``torch.func.vmap`` over the per-client
function, the reference's ``vmap``) against its plain version, the
per-client loop ``client_transmits``, on the CPU.

Both take the same arguments (``client_inputs`` of one session state and
one round's batch, after two rounds so the client banks hold values) and
return the transmit sum, the loss and aux sums and the new bank rows.
They differ only in the order of f32 sums (a batched product, the stack
summed over the clients), so each output is compared at ``rtol 1e-5`` and
``atol 1e-6 * max|.|``; the bank rows of masked clients are bit-equal to
the old rows, and the DP draws bit-equal to ``dp_noise`` of their keys.

At tests/test_round.py's TinyMLP size, one parametrised test over the
modes and settings that run per client; the exact top-k's mask form
against the ``nonzero`` form; ``gpt2_tiny`` with the clip; and the round
itself, which runs the batched step and never the loop.
"""

import warnings

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.data import FedSampler
from commefficient_tpu_torch.fedsim import RoundEnv
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops.topk import (
    SCAN_BLOCK,
    topk_dense,
    topk_sparsify,
    topk_threshold_dense,
)
from commefficient_tpu_torch.parallel import FederatedSession, mask_gpt2
from commefficient_tpu_torch.parallel import round as round_mod
from commefficient_tpu_torch.parallel.api import _to_device, microbatched
from commefficient_tpu_torch.parallel.round import (
    batched_client_transmits,
    client_inputs,
    client_transmits,
    dp_noise,
    make_grad_one,
    make_per_client,
)
from commefficient_tpu_torch.utils.config import Config
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

LR = 0.2
ONE = {**BASE, "num_devices": 1}
RTOL, ATOL = 1e-5, 1e-6  # atol times max|.| of the loop's output
LOCAL_TOPK = dict(mode="local_topk", error_type="local", local_momentum=0.9,
                  k=30)
# fedsim masks over the 8 clients: 1 dropped, 2 corrupted and live, 4
# corrupted and dropped
LIVE = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
CORRUPT = np.array([0, 0, 1, 0, 1, 0, 0, 0], np.float32)
CASES = {
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=60, num_rows=5, num_cols=512),
    "sketch_local_momentum": dict(mode="sketch", error_type="virtual",
                                  virtual_momentum=0.9, local_momentum=0.9,
                                  k=60, num_rows=5, num_cols=512),
    "local_topk_exact": LOCAL_TOPK,
    "local_topk_threshold": dict(LOCAL_TOPK, topk_method="threshold"),
    "fedavg": dict(mode="fedavg", num_local_iters=2),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9, k=40),
    "powersgd": dict(mode="powersgd", error_type="virtual", powersgd_rank=2,
                     virtual_momentum=0.9),
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9),
    "weight_decay_clip": dict(mode="uncompressed", weight_decay=5e-4,
                              max_grad_norm=1.0),
    "clip_dp": dict(mode="uncompressed", max_grad_norm=1.0,
                    dp_noise_multiplier=0.5),
    "fedavg_clip_dp": dict(mode="fedavg", num_local_iters=2,
                           max_grad_norm=1.0, dp_noise_multiplier=0.5),
    # dropped and corrupted-dropped clients: the sums stay finite
    "fedsim_dropped": dict(LOCAL_TOPK, _live=LIVE,
                           _corrupt=np.where(LIVE > 0, 0, CORRUPT)),
    # a corrupted live client: every coordinate of the sum is NaN
    "fedsim_corrupted_live": dict(LOCAL_TOPK, _live=LIVE, _corrupt=CORRUPT),
}


@pytest.fixture(scope="module")
def setup():
    return _setup(BASE["num_clients"])


def _session_inputs(setup, kw):
    """(per_client, the client step's arguments, the session, the round's
    client ids, grad_one) after two rounds of a port session, at the
    third round's batch."""
    ds, params, _ = setup
    kw = dict(kw)
    live, corrupt = kw.pop("_live", None), kw.pop("_corrupt", None)
    cfg = Config(**{**ONE, **kw}, device="cpu")
    loss_fn = classification_loss(torch_tinymlp)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*dampening=AUTO")
        sess = FederatedSession(cfg, to_numpy_tree(params), loss_fn)
    sampler = FedSampler(ds, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size, seed=1)
    for r in range(2):
        ids, batch = sampler.sample_round(r)
        sess.train_round(ids, microbatched(cfg, batch), LR)
    ids, batch = sampler.sample_round(2)
    env = None if live is None else RoundEnv(live, corrupt,
                                             np.float32(live.sum()), {})
    args = client_inputs(cfg, sess.compressor, sess.state,
                         torch.from_numpy(ids.astype(np.int64)),
                         _to_device(microbatched(cfg, batch), "cpu"), LR,
                         env)
    grad_one = make_grad_one(cfg, loss_fn, sess.unravel)
    return (make_per_client(cfg, sess.compressor, grad_one), args, sess,
            ids, grad_one)


def _assert_close(got, want, what):
    want = want.numpy()
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=what)


def _assert_step_close(got, want, nan_sum=False):
    """Every output at the tolerances; with ``nan_sum`` (a corrupted live
    client) the transmit sums must both be NaN at every coordinate."""
    t, loss, aux, vel, err = got
    t0, loss0, aux0, vel0, err0 = want
    if nan_sum:
        assert torch.isnan(t).all() and torch.isnan(t0).all()
    else:
        _assert_close(t, t0, "transmit sum")
    _assert_close(loss, loss0, "loss sum")
    assert sorted(aux) == sorted(aux0)
    for k in aux0:
        _assert_close(aux[k], aux0[k], f"aux {k}")
    for new, new0, what in ((vel, vel0, "vel rows"), (err, err0, "err rows")):
        assert (new is None) == (new0 is None), what
        if new0 is not None:
            _assert_close(new, new0, what)


def _kth_gap(e: torch.Tensor, k: int) -> float:
    """The gap between the k-th and (k+1)-th largest |e| over the last
    dimension, the smallest over the rows."""
    top = torch.topk(torch.abs(e), k + 1, dim=-1).values
    return float(torch.min(top[..., k - 1] - top[..., k]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_step_equals_the_loop(setup, name):
    per_client, args, sess, ids, grad_one = _session_inputs(setup,
                                                            CASES[name])
    cfg = sess.cfg
    params, batch, vel, err, lr, noise, live, corrupt = args
    want = client_transmits(per_client, *args)
    got = batched_client_transmits(per_client, *args)
    if cfg.mode == "local_topk":
        # a top-k selects per client: where the k-th gap of the
        # pre-selection vectors lies inside the tolerance, a flipped
        # near-tie is the order of the sums, not a fault, and the
        # pre-selection vectors are compared instead
        g = torch.func.vmap(grad_one, in_dims=(None, 0))(params, batch)[0]
        e = err + lr * (cfg.local_momentum * vel + g)
        scale = float(torch.max(torch.abs(e)))
        if _kth_gap(e, cfg.k) <= RTOL * scale + ATOL * scale:
            g0 = torch.stack([grad_one(params, {k: v[i] for k, v in
                                                batch.items()})[0]
                              for i in range(g.shape[0])])
            _assert_close(g, g0, "pre-selection gradients")
            return
    _assert_step_close(got, want, nan_sum=name == "fedsim_corrupted_live")
    if live is not None:  # masked clients' rows carry forward bit for bit
        off = live == 0
        for new, old in ((got[3], vel), (got[4], err)):
            assert torch.equal(new[off], old[off])
    if noise is not None:  # the draws are their keys' draws
        for i, cid in enumerate(ids):
            key = (sess.state.step, int(cid))
            want_draw = (dp_noise(cfg.seed, key, sess.grad_size, "cpu")
                         if cfg.mode != "fedavg" else torch.stack(
                             [dp_noise(cfg.seed, (*key, s), sess.grad_size,
                                       "cpu")
                              for s in range(cfg.num_local_iters)]))
            assert torch.equal(noise[i], want_draw)


def test_batched_step_under_no_grad_equals_the_step_outside_it(setup):
    """``torch.func.grad`` inside the round's ``torch.no_grad``
    differentiates all the same."""
    per_client, args = _session_inputs(setup, CASES["local_topk_exact"])[:2]
    outside = batched_client_transmits(per_client, *args)
    with torch.no_grad():
        inside = batched_client_transmits(per_client, *args)
    assert torch.equal(inside[0], outside[0])
    assert float(torch.linalg.vector_norm(inside[0])) > 0
    assert torch.equal(inside[4], outside[4])


def test_dp_noise_by_key_equals_the_drawn_noise_argument(setup):
    """``make_grad_one`` given a DP key draws what ``client_inputs`` drew
    for that client: the gradient is bit-equal either way."""
    _, args, sess, ids, grad_one = _session_inputs(setup, CASES["clip_dp"])
    params, batch, _, _, _, noise, _, _ = args
    for i in (0, 5):
        b = {k: v[i] for k, v in batch.items()}
        key = (sess.state.step, int(ids[i]))
        by_key = grad_one(params, b, key)[0]
        assert torch.equal(by_key, grad_one(params, b, noise=noise[i])[0])
        assert torch.equal(noise[i], dp_noise(sess.cfg.seed, key,
                                              sess.grad_size, "cpu"))
    with pytest.raises(ValueError, match="DP noise needs the draw's key"):
        grad_one(params, {k: v[0] for k, v in batch.items()})


def test_round_runs_the_batched_step_not_the_loop(setup, monkeypatch):
    """``round_fn``'s per-client branch calls ``batched_client_transmits``
    and never ``client_transmits``."""
    calls = []
    batched = round_mod.batched_client_transmits

    def spy(*a, **kw):
        calls.append(1)
        return batched(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the round called the per-client loop")

    monkeypatch.setattr(round_mod, "batched_client_transmits", spy)
    monkeypatch.setattr(round_mod, "client_transmits", refuse)
    _session_inputs(setup, CASES["sketch_local_momentum"])
    assert len(calls) == 2  # the two rounds the helper runs


# -- the exact top-k's mask form ---------------------------------------------


def _nonzero_form(v, k):
    vals, idx = topk_sparsify(v, k)
    out = torch.zeros_like(v)
    out[idx] = vals
    return out


def _tie_vectors():
    rng = np.random.default_rng(0)
    out = []
    for d in (1, 7, 40, 257):
        for _ in range(6):
            # few distinct magnitudes, both signs: ties at the k-th place
            v = rng.integers(-3, 4, d).astype(np.float32)
            for k in sorted({1, max(1, d // 3), max(1, d // 2), d}):
                out.append((v, k))
        out.append((np.zeros(d, np.float32), max(1, d // 2)))
        out.append((np.zeros(d, np.float32), d))
    out.append((rng.normal(size=300).astype(np.float32), 300))
    # ties across topk_dense's scan blocks (ops.topk.SCAN_BLOCK)
    long = rng.integers(-2, 3, 3 * SCAN_BLOCK + 5).astype(np.float32)
    out += [(long, k) for k in (1, 2500, 7000, long.size)]
    nan = rng.normal(size=50).astype(np.float32)
    nan[[3, 17]] = np.nan
    out += [(nan, 1), (nan, 10), (-np.zeros(9, np.float32), 4)]
    return out


@pytest.mark.parametrize("case", ["ties", "vmap"])
def test_topk_mask_form_equals_the_nonzero_form(case):
    if case == "ties":
        for v, k in _tie_vectors():
            t = torch.from_numpy(v)
            got, want = topk_dense(t, k), _nonzero_form(t, k)
            assert torch.equal(got, want), (v, k)
            assert torch.equal(torch.signbit(got), torch.signbit(want))
            assert int(torch.count_nonzero(got)) <= k
        return
    rng = np.random.default_rng(1)
    n = 2 * SCAN_BLOCK + 3  # rows over three scan blocks
    rows = torch.from_numpy(rng.integers(-4, 5, (6, n)).astype(np.float32))
    for k in (1, 13, 4100, n):
        want = torch.stack([_nonzero_form(r, k) for r in rows])
        assert torch.equal(torch.func.vmap(lambda r: topk_dense(r, k))(rows),
                           want)
        assert torch.equal(topk_dense(rows, k), want)
        assert torch.equal(
            torch.func.vmap(lambda r: topk_threshold_dense(r, k))(rows),
            torch.stack([topk_threshold_dense(r, k) for r in rows]))


# -- gpt2_tiny with the clip -------------------------------------------------


def test_gpt2_tiny_batched_step_with_clip_equals_the_loop():
    from commefficient_tpu_torch.train.gpt2_train import build_model_and_data

    n = torch.get_num_threads()
    torch.set_num_threads(2)  # launch-sized products: few threads
    try:
        cfg = Config(model="gpt2_tiny", dataset_name="personachat",
                     mode="sketch", error_type="virtual",
                     virtual_momentum=0.9, k=500, num_rows=3,
                     num_cols=20_000, num_clients=4, num_workers=4,
                     num_devices=1, local_batch_size=2, max_seq_len=32,
                     compute_dtype="float32", max_grad_norm=1.0, seed=3,
                     dataset_dir="/nonexistent", device="cpu")
        train, _, _, _, _, params, loss_fn = build_model_and_data(cfg)
        sess = FederatedSession(cfg, params, loss_fn, mask_batch=mask_gpt2)
        ids, batch = FedSampler(train, num_workers=4, local_batch_size=2,
                                seed=3).sample_round(0)
        args = client_inputs(cfg, sess.compressor, sess.state, None,
                             _to_device(batch, "cpu"), 0.1)
        per_client = make_per_client(cfg, sess.compressor, make_grad_one(
            cfg, loss_fn, sess.unravel))
        want = client_transmits(per_client, *args)
        got = batched_client_transmits(per_client, *args)
    finally:
        torch.set_num_threads(n)
    _assert_step_close(got, want)
    assert float(torch.linalg.vector_norm(got[0])) <= 4 * 1.0 * (1 + 1e-5)


# -- make_grad_one's two forms on ResNet-9 ---------------------------------


def test_resnet9_gradient_forms():
    """``make_grad_one(batched=False)``, the fused path's form, is plain
    ``torch.autograd.grad`` bit for bit (the sketch-fused backward's
    twin). The ``torch.func`` form, the batched clients', records the
    backward's graph, so group norm's backward is autograd's composite:
    in f32 the two forms agree to f32 rounding; in bf16 the composite
    moves the gradient by far less than bf16 compute's own error (each
    form's distance from f64 compute within 1% of the other's). Its
    ``vmap`` over two clients equals the loop to f32 rounding."""
    from functools import partial

    from commefficient_tpu_torch.data import (
        CIFAR10_MEAN,
        CIFAR10_STD,
        normalizer,
    )
    from commefficient_tpu_torch.models.resnet9 import (
        init_resnet9,
        resnet9_apply,
    )
    from commefficient_tpu_torch.ops.param_utils import (
        ravel_params,
        tree_leaves,
    )

    def loss_in(dtype):
        return classification_loss(partial(resnet9_apply, dtype=dtype),
                                   prep=normalizer(CIFAR10_MEAN,
                                                   CIFAR10_STD))

    vec, unravel = ravel_params(init_resnet9(0, width=16))
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.integers(0, 256, (2, 8, 32, 32, 3),
                                                dtype=np.uint8)),
             "y": torch.from_numpy(rng.integers(0, 10, (2, 8)))}
    b0 = {k: v[0] for k, v in batch.items()}
    cfg = Config(mode="uncompressed", weight_decay=0.0, device="cpu")
    forms = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("f64", torch.float64)):
        loss_fn = loss_in(dtype)
        tree = unravel(vec.detach())
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(tree)]
        with torch.enable_grad():
            want = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
                loss_fn(tree, b0)[0], leaves)])
        flat = make_grad_one(cfg, loss_fn, unravel, batched=False)
        assert torch.equal(flat(vec, b0)[0], want)
        forms[name] = (make_grad_one(cfg, loss_fn, unravel)(vec, b0)[0],
                       want)
    func, auto = forms["f32"]
    _assert_close(func, auto, "f32: torch.func against autograd")
    exact = forms["f64"][1]

    def dist(g):
        return float(torch.linalg.vector_norm(g - exact))

    func, auto = forms["bf16"]
    assert abs(dist(func) - dist(auto)) <= 0.01 * dist(auto)
    grad_one = make_grad_one(cfg, loss_in(torch.float32), unravel)
    loop = torch.stack([grad_one(vec, {k: v[i] for k, v in batch.items()})[0]
                        for i in range(2)])
    _assert_close(torch.func.vmap(grad_one, in_dims=(None, 0))(vec, batch)[0],
                  loop, "vmap against the loop")

"""The port's sketch-fused backward against the JAX package, on the CPU.

``sketch_fused_bwd`` (mode sketch on the fused flattened-batch path) makes
the device's gradient directly as a CountSketch table: every parameter
leaf goes through a ``SketchGradTap`` whose backward sketches the leaf's
cotangent (``sketch_segment``, K1's segment form on the card), and the
flat ``[D]`` gradient never exists. Pinned here, at tests/test_round.py's
TinyMLP size:

* the tap: its forward is the identity, and its table equals the
  reference's ``jax.grad`` through ``sketch_grad_tap`` (atol 1e-6) and
  ``sketch_vec`` of the concatenated gradient (atol ``1e-5 * scale``),
  as tests/test_sketch_fused_bwd.py pins the reference (the reference's
  taps return it as the table's cotangent, the port's add it into the
  one table's storage);
* ``sketch_segment``'s plain version against the reference's
  ``sketch_segment`` (atol 1e-6, the reference's own tolerance between its
  scatter paths) over leaves of 1, 63, 64 and 65 values, offsets across a
  scramble block, the last leaf ending at d, r of 1, 3 and 5, both hash
  families, and ResNet-9's and GPT-2's geometries;
* the gradient table against the reference's ``make_sketch_grad_one``
  called under ``jax.jit`` on one flattened batch, weight decay on (atol
  ``1e-5 * max|table|``: scatter, fan-in and the weight-decay sketch sum
  in another order);
* four rounds of the fused-backward round against the port's own
  dense-grad fused round (itself held against the reference by
  test_torch_compressors.py), f32 and bf16 tables, weight decay on, to
  ``atol 5e-5 * max(|p|, 1)``, the reference's own parity bound;
* no tensor of D elements is created while the fused backward runs (a
  ``TorchDispatchMode`` records every tensor), while the dense-grad
  gradient does create one (the marker is live);
* the six refusals of ``Config``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.ops import countsketch as ref_cs
from commefficient_tpu.parallel.round import (
    make_sketch_grad_one as ref_make_sketch_grad_one,
)
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.models import classification_loss
from commefficient_tpu_torch.ops import countsketch as cs
from commefficient_tpu_torch.ops.param_utils import ravel_params
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.round import (
    leaf_offsets,
    make_grad_one,
    make_sketch_grad_one,
)
from commefficient_tpu_torch.utils.config import Config
from test_round import BASE, _setup
from test_torch_model import to_numpy_tree, torch_tinymlp

ONE = {**BASE, "num_devices": 1}
FUSED = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
             k=40, num_rows=3, num_cols=256, topk_method="threshold",
             fuse_clients=True, weight_decay=1e-4)


@pytest.fixture(scope="module")
def setup():
    ds, params, loss_ref = _setup(BASE["num_clients"])
    return ds, jax.tree.map(np.asarray, params), loss_ref


def _flat_batch(ds):
    """One round's batch of the reference's sampler, flattened to [W*B]."""
    ids, batch = RefSampler(ds, num_workers=8, local_batch_size=4,
                            seed=1).sample_round(0)
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}


# -- the tap and the segment sketch -------------------------------------------


def _sketch_through_taps(spec, leaves_offsets, loss):
    """The table the taps fill during the backward of ``loss(tapped)``."""
    table = torch.zeros(spec.table_shape, requires_grad=True)
    tapped = [cs.SketchGradTap.apply(leaf, table, spec, off)
              for leaf, off in leaves_offsets]
    grads = torch.autograd.grad(loss(*tapped), [table], allow_unused=True)
    assert grads == (None,)  # the sum is in the table's storage
    return table.detach()


def test_tap_forward_is_identity():
    spec = cs.CountSketch(d=8, c=8, r=1, seed=3)
    leaf = torch.arange(8.0)
    out = cs.SketchGradTap.apply(leaf, torch.zeros(spec.table_shape,
                                                   requires_grad=True),
                                 spec, 0)
    assert torch.equal(out, leaf)


def test_tap_table_equals_reference_and_sketch_of_concat():
    """The reference's test_tap_accumulates_sketch_of_full_gradient, with
    the same leaves, loss and spec through both packages."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    x = rng.normal(size=(4,)).astype(np.float32)
    ref_spec = ref_cs.CountSketch(d=48, c=32, r=3, seed=3)

    def ref_tapped(table):
        aa = ref_cs.sketch_grad_tap(ref_spec, 0, jnp.asarray(a), table)
        bb = ref_cs.sketch_grad_tap(ref_spec, 16, jnp.asarray(b), table)
        return jnp.sum(jnp.sin(aa) * x[None, :]) + jnp.sum(bb * bb)

    want = np.asarray(jax.grad(ref_tapped)(
        jnp.zeros(ref_spec.table_shape, jnp.float32)))
    spec = cs.CountSketch(d=48, c=32, r=3, seed=3)
    ta, tb = (torch.from_numpy(v) for v in (a, b))
    got = _sketch_through_taps(
        spec, [(ta, 0), (tb, 16)],
        lambda aa, bb: (torch.sin(aa) * torch.from_numpy(x)[None, :]).sum()
        + (bb * bb).sum())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the sum of the segment sketches is the sketch of the concatenation
    flat = torch.cat([(torch.cos(ta) * torch.from_numpy(x)[None, :]
                       ).reshape(-1), 2 * tb])
    full = cs.sketch_vec(spec, flat).numpy()
    scale = max(np.abs(full).max(), 1.0)
    np.testing.assert_allclose(got.numpy(), full, rtol=0, atol=1e-5 * scale)


def test_tap_passes_the_cotangent_to_a_leaf_that_requires_it():
    spec = cs.CountSketch(d=8, c=8, r=2, seed=3)
    leaf = torch.arange(8.0, requires_grad=True)
    table = torch.zeros(spec.table_shape, requires_grad=True)
    out = cs.SketchGradTap.apply(leaf, table, spec, 0)
    g_leaf, g_table = torch.autograd.grad((out * out).sum(), [leaf, table],
                                          allow_unused=True)
    assert torch.equal(g_leaf, 2 * leaf.detach()) and g_table is None
    assert torch.allclose(table.detach(),
                          cs.sketch_vec(spec, 2 * leaf.detach()), atol=1e-5)


SEGMENT_SPECS = {  # name -> (d, c, r, family)
    "r1_fmix32": (3_001, 600, 1, "fmix32"),
    "r3_poly4": (20_011, 4_000, 3, "poly4"),
    "r5_fmix32": (20_011, 4_000, 5, "fmix32"),
    "resnet9": (6_573_130, 500_000, 5, "fmix32"),
    "gpt2": (124_444_417, 5_000_000, 5, "fmix32"),
}


@pytest.mark.parametrize("name", sorted(SEGMENT_SPECS))
def test_sketch_segment_plain_version_equals_reference(name):
    d, c, r, family = SEGMENT_SPECS[name]
    spec = cs.CountSketch(d=d, c=c, r=r, hash_family=family)
    ref_spec = ref_cs.CountSketch(d=d, c=c, r=r, hash_family=family)
    b = spec.sblock
    rng = np.random.default_rng(2)
    cases = [(0, 1), (b - 1, 63), (d // 2 // b * b, 64),
             (d // 3 // b * b + b // 2, 65), (d - 65, 65)]
    if d > 10**6:  # the reference compiles each leaf size anew: two here
        cases = [(b - 1, 63), (d - 65, 65)]
    for offset, n in cases:
        vals = rng.normal(size=n).astype(np.float32)
        want = np.asarray(ref_cs.sketch_segment(ref_spec, offset,
                                                jnp.asarray(vals)))
        got = cs.sketch_segment(spec, offset, torch.from_numpy(vals))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=f"{name} offset={offset} n={n}")
        # and into a table that already holds values
        got2 = cs.sketch_segment(spec, offset, torch.from_numpy(vals),
                                 torch.full(spec.table_shape, 0.5))
        np.testing.assert_allclose(got2.numpy(), 0.5 + want, rtol=0,
                                   atol=1e-5)


# -- the fused-backward gradient and round ------------------------------------


def test_fused_gradient_table_equals_reference(setup):
    """The reference's make_sketch_grad_one on one flattened batch, under
    jax.jit, outside shard_map (inside it, jax 0.9.0's checks refuse the
    table), weight decay on."""
    ds, params, loss_ref = setup
    kw = {**ONE, **FUSED, "sketch_fused_bwd": True}
    vec, unravel = ravel_pytree(params)
    d = int(vec.size)
    ref_spec = ref_cs.CountSketch(d=d, c=256, r=3, seed=BASE["seed"])
    ref_fn = ref_make_sketch_grad_one(RefConfig(**kw), loss_ref, unravel,
                                      None, ref_spec, d=d)
    flat = _flat_batch(ds)
    want_table, want_loss, _ = jax.jit(ref_fn)(
        vec, jax.tree.map(jnp.asarray, flat), jax.random.key(0))
    pvec, punravel = ravel_params(to_numpy_tree(params))
    spec = cs.CountSketch(d=d, c=256, r=3, seed=BASE["seed"])
    fn = make_sketch_grad_one(Config(**kw, device="cpu"),
                              classification_loss(torch_tinymlp), punravel,
                              spec, d)
    table, loss, _ = fn(pvec, {k: torch.from_numpy(v)
                               for k, v in flat.items()})
    want_table = np.asarray(want_table)
    scale = max(np.abs(want_table).max(), 1.0)
    np.testing.assert_allclose(table.numpy(), want_table, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)


def _session(setup, **kw):
    _, params, _ = setup
    return FederatedSession(Config(**{**ONE, **FUSED, **kw}, device="cpu"),
                            to_numpy_tree(params),
                            classification_loss(torch_tinymlp))


def _train(setup, sess, n_rounds=4, lr=0.2):
    ds = setup[0]
    sampler = RefSampler(ds, num_workers=8, local_batch_size=4, seed=1)
    losses = []
    for r in range(n_rounds):
        ids, batch = sampler.sample_round(r)
        losses.append(float(sess.train_round(ids, batch, lr)["loss"]))
    return losses


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_fused_round_matches_dense_grad_fused_round(setup, table_dtype):
    dense = _session(setup, sketch_table_dtype=table_dtype)
    fused = _session(setup, sketch_table_dtype=table_dtype,
                     sketch_fused_bwd=True)
    p0 = fused.state.params_vec.clone()
    l_dense, l_fused = _train(setup, dense), _train(setup, fused)
    p_d, p_f = dense.state.params_vec, fused.state.params_vec
    scale = max(float(p_d.abs().max()), 1.0)
    assert float((p_f - p_d).abs().max()) <= 5e-5 * scale
    np.testing.assert_allclose(l_fused, l_dense, atol=1e-3)
    assert float((p_f - p0).abs().max()) > 1e-3  # the rounds moved it
    assert fused.state.momentum.dtype == getattr(torch, table_dtype)


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)}


class _Created(TorchDispatchMode):
    """Records the element count of every tensor an op returns in new
    storage (views of an input, such as ``detach``, allocate nothing)."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = _storages((args, kwargs))
        self.numels += [t.numel() for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)
                        and t.untyped_storage().data_ptr() not in seen]
        return out


def test_fused_backward_creates_no_flat_gradient(setup):
    """The torch twin of test_fused_bwd_hlo_free_of_flat_grad_concat: the
    fused backward (forward, backward and the weight-decay sketch) makes
    no tensor of D elements; the dense-grad gradient makes one (the
    flat concatenation), so the record can see it."""
    ds, params, _ = setup
    pvec, unravel = ravel_params(to_numpy_tree(params))
    d = pvec.numel()
    cfg = Config(**{**ONE, **FUSED, "sketch_fused_bwd": True}, device="cpu")
    spec = cs.CountSketch(d=d, c=256, r=3, seed=BASE["seed"])
    loss_fn = classification_loss(torch_tinymlp)
    batch = {k: torch.from_numpy(v) for k, v in _flat_batch(ds).items()}
    fused = make_sketch_grad_one(cfg, loss_fn, unravel, spec, d)
    dense = make_grad_one(cfg, loss_fn, unravel)
    with _Created() as rec_fused:
        fused(pvec, batch)
    with _Created() as rec_dense:
        dense(pvec, batch)
    assert rec_fused.numels and d not in rec_fused.numels
    assert d in rec_dense.numels
    assert sum(n for _, n in leaf_offsets(unravel, d)) == d


@pytest.mark.parametrize("kw,needle", [
    (dict(mode="true_topk"), "mode"),
    (dict(fuse_clients=False), "fuse_clients"),
    (dict(local_momentum=0.5), "local_momentum"),
    (dict(max_grad_norm=1.0), "max_grad_norm"),
    (dict(dp_noise_multiplier=0.1), "DP noise"),
    (dict(availability="bernoulli", dropout_prob=0.3), "fedsim"),
])
def test_fused_bwd_incompatible_knobs_refused(kw, needle):
    base = dict(ONE, mode="sketch", error_type="virtual", k=40, num_rows=3,
                num_cols=256, topk_method="threshold", fuse_clients=True,
                sketch_fused_bwd=True)
    base.update(kw)
    with pytest.raises(ValueError, match=needle):
        Config(**base)


def test_round_builder_refuses_a_fused_bwd_without_the_fused_path(setup):
    """The builder's own guard (``build_round_fn``), behind Config's."""
    from commefficient_tpu_torch.compress import get_compressor
    from commefficient_tpu_torch.parallel.mesh import SingleWorker
    from commefficient_tpu_torch.parallel.round import build_round_fn

    cfg = Config(**{**ONE, **FUSED}, device="cpu")
    comp = get_compressor(cfg, d=212, spec=cs.CountSketch(d=212, c=256,
                                                          r=3))
    object.__setattr__(cfg, "sketch_fused_bwd", True)
    object.__setattr__(cfg, "fuse_clients", False)
    with pytest.raises(ValueError, match="fused flattened-batch"):
        build_round_fn(cfg, None, None, comp, SingleWorker())

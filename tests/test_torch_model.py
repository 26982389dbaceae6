"""The port's models and flat parameter vector against the flax reference.

Both packages run on the CPU here. Inputs are numpy arrays made from a seed;
the reference's params (JAX PRNG) are exported as numpy and carried into the
port with ``interop.params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models.losses import classification_loss as jax_loss
from commefficient_tpu.models.resnet9 import ResNet9
from commefficient_tpu_torch.interop import params_from_jax, params_to_jax
from commefficient_tpu_torch.models import (
    classification_loss,
    resnet9_apply,
    resnet9_shapes,
)
from commefficient_tpu_torch.ops.param_utils import ravel_params, tree_leaves
from test_round import TinyMLP, D_IN, N_CLASSES


def torch_tinymlp(params, x):
    """The port of tests/test_round.py's TinyMLP (flax Dense: x @ kernel +
    bias, kernel [in, out])."""
    p = params["params"]
    h = torch.relu(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
    return h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _resnet9_case(width=4, dtype=jnp.float32, batch=6, seed=0):
    model = ResNet9(num_classes=10, width=width, dtype=dtype)
    # jit: flax's op-by-op init takes ~20 s on the CPU
    params = jax.jit(model.init)(jax.random.key(seed),
                                 jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int32)
    return model, params, x, y


def _jax_loss_and_grad(apply_fn, params, x, y):
    loss_fn = jax_loss(apply_fn)

    def f(p):
        return loss_fn(p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})

    (loss, aux), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return float(loss), aux, np.asarray(ravel_pytree(g)[0])


def _torch_loss_and_grad(apply_fn, params, x, y):
    vec, unravel = ravel_params(to_numpy_tree(params))
    vec.requires_grad_(True)
    loss, aux = classification_loss(apply_fn)(
        unravel(vec), {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    (g,) = torch.autograd.grad(loss, vec)
    return float(loss.detach()), aux, g.numpy()


def test_ravel_order_round_trips_bit_identically():
    _, params, _, _ = _resnet9_case()
    want = np.asarray(ravel_pytree(params)[0])
    got = params_from_jax(to_numpy_tree(params))
    np.testing.assert_array_equal(got.numpy(), want)
    back = params_to_jax(got, to_numpy_tree(params))
    for (pa, a), (pb, b) in zip(tree_leaves(back),
                                tree_leaves(to_numpy_tree(params))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    # the port's own layout names and shapes every leaf like flax does
    shapes = [(p, tuple(s)) for p, s in tree_leaves(resnet9_shapes(10, 4))]
    assert shapes == [(p, tuple(np.shape(a)))
                      for p, a in tree_leaves(to_numpy_tree(params))]
    vec, unravel = ravel_params(to_numpy_tree(params))
    np.testing.assert_array_equal(vec.numpy(), want)
    # unravel returns views: writing through one lands in the flat vector
    unravel(vec)["params"]["Dense_0"]["bias"][0] = 123.0
    assert 123.0 in vec


def test_tinymlp_loss_and_grad_match_flax():
    model = TinyMLP()
    params = model.init(jax.random.key(0), jnp.zeros((1, D_IN)))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, D_IN)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, size=16).astype(np.int32)
    lj, auxj, gj = _jax_loss_and_grad(model.apply, params, x, y)
    lt, auxt, gt = _torch_loss_and_grad(torch_tinymlp, params, x, y)
    # fp32, different summation order in the matmuls: a few ulp
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-6)
    assert float(auxt["correct"]) == float(auxj["correct"])


def test_resnet9_logits_loss_grad_match_flax_float32():
    model, params, x, y = _resnet9_case(width=4, dtype=jnp.float32)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))
    vec, unravel = ravel_params(to_numpy_tree(params))
    got = resnet9_apply(unravel(vec), torch.from_numpy(x),
                        dtype=torch.float32).numpy()
    # fp32 convs and GroupNorm (eps 1e-6) in another summation order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    lj, _, gj = _jax_loss_and_grad(model.apply, params, x, y)
    apply32 = lambda p, xx: resnet9_apply(p, xx, dtype=torch.float32)  # noqa: E731
    lt, _, gt = _torch_loss_and_grad(apply32, params, x, y)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)


def test_resnet9_mixed_precision_close_to_flax():
    """compute_dtype='mixed': bf16 weights and activations inside the loss,
    f32 master params and f32 cross-entropy. bf16 keeps 8 bits of
    mantissa and the two frameworks round at different places (conv
    accumulation, GroupNorm output), so the bound is bf16-scale: logits
    within 3% of their range and loss within 2%. The gradient is looser
    still: bf16 activations tie often, and the two frameworks route a
    max-pool's gradient to different members of a tie, so its relative L2
    error is bounded at 25% (measured ~15% at width 4)."""
    model, params, x, y = _resnet9_case(width=4, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))
    vec, unravel = ravel_params(to_numpy_tree(params))
    got = resnet9_apply(unravel(vec), torch.from_numpy(x),
                        dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    lj, _, gj = _jax_loss_and_grad(model.apply, params, x, y)
    lt, _, gt = _torch_loss_and_grad(resnet9_apply, params, x, y)
    np.testing.assert_allclose(lt, lj, rtol=2e-2)
    assert np.linalg.norm(gt - gj) < 0.25 * np.linalg.norm(gj)


@pytest.mark.parametrize("max_norm", [None, 0.5])
def test_clip_by_global_norm_matches_reference(max_norm):
    from commefficient_tpu.ops.param_utils import clip_by_global_norm as ref
    from commefficient_tpu_torch.ops.param_utils import clip_by_global_norm

    v = np.random.default_rng(2).normal(size=1000).astype(np.float32)
    got = clip_by_global_norm(torch.from_numpy(v), max_norm).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(v), max_norm)),
                               rtol=1e-6)

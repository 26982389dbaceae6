"""The port's FixupResNet, ResNet-9 on one input channel, and four-round
twins of the new datasets' configurations against the reference, on the
CPU.

Fixup starts every branch's last conv and the head at zero, so at init the
gradients of each branch's first two convs are exactly zero and a parity
test from the init checks almost nothing. The forward and gradient tests
and the twins therefore start from perturbed params: seeded numpy noise
added to every leaf of flax's init, carried into the port as numpy
(``interop.params_from_jax`` order). One test pins the init's structure
itself. The model is cut to ``stage_sizes=(1, 1, 1, 1)``, width 8, 10
classes at 32x32 (a stride-2 block at every stage but the first, each with
a projection shortcut); the full FixupResNet-50 is checked by
``jax.eval_shape`` only, with nothing compiled.

Tolerances: float32 loss ``rtol 1e-6`` and gradient ``atol 1e-5``, the
bound tests/test_torch_model.py holds ResNet-9's gradient to (fp32 convs
summed in another order; the perturbed net's gradients are of order 1,
so 1e-6 absolute is a few ulp); ``compute_dtype="mixed"`` loss ``rtol
2e-2`` and the gradient's relative L2 error below 0.15 (bf16 convs
rounded at other places flip a few ReLUs and max-pool ties, which moves
single entries by a sizable share of max|g| for some draws of the
perturbation and not others, so the bound is on the whole gradient, as
tests/test_torch_model.py bounds ResNet-9's mixed gradient); the twins
as tests/test_torch_compressors.py's (losses ``rtol 1e-4``, params
``atol 1e-5``, other leaves ``atol 1e-5 * max|leaf|``).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.data import FedDataset as RefDataset
from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.data.cifar import device_normalizer
from commefficient_tpu.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
from commefficient_tpu.models.fixup_resnet import FixupResNet, fixup_resnet50
from commefficient_tpu.models.losses import classification_loss as jax_loss
from commefficient_tpu.models.resnet9 import ResNet9
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.data import normalizer
from commefficient_tpu_torch.interop import state_from_jax, state_to_jax
from commefficient_tpu_torch.models import (
    classification_loss,
    fixup_resnet_apply,
    fixup_resnet_shapes,
    init_fixup_resnet,
    init_resnet9,
    resnet9_apply,
    resnet9_shapes,
)
from commefficient_tpu_torch.ops.param_utils import ravel_params, tree_leaves
from commefficient_tpu_torch.parallel import FederatedSession
from commefficient_tpu_torch.parallel.api import microbatched
from commefficient_tpu_torch.utils.config import Config
from test_torch_compressors import _assert_state_twin, _leaves
from test_torch_model import (
    _jax_loss_and_grad,
    _torch_loss_and_grad,
    to_numpy_tree,
)

SMALL = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
D_SMALL = 128_576  # FixupResNet (1, 1, 1, 1), width 8, 10 classes
D_FIXUP50 = 25_504_026  # FixupResNet-50, 1000 classes (BASELINE #5)


def perturbed(params, seed=0, scale=0.1):
    """Every leaf of ``params`` plus seeded N(0, scale^2) noise, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: np.asarray(v) + rng.normal(
        0, scale, size=np.shape(v)).astype(np.float32), params)


@functools.lru_cache(maxsize=None)
def _fixup_init(dtype_name: str, size: int = 32):
    model = FixupResNet(**SMALL, dtype=jnp.dtype(dtype_name))
    params = jax.jit(model.init)(jax.random.key(0),
                                 jnp.zeros((1, size, size, 3)))
    return model, to_numpy_tree(params)


def _inputs(size, batch=6, seed=1, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, size=batch).astype(np.int32))


def test_fixup_resnet50_keys_shapes_and_size_follow_flax():
    """No compile: flax's ``eval_shape`` of the full net, at 64 and 224 px,
    against ``fixup_resnet_shapes``; D is BASELINE #5's."""
    want = fixup_resnet_shapes()
    for px in (64, 224):
        shapes = jax.eval_shape(fixup_resnet50(1000).init, jax.random.key(0),
                                jnp.zeros((1, px, px, 3)))
        got = [(p, tuple(s.shape)) for p, s in tree_leaves(shapes)]
        assert got == [(p, tuple(s)) for p, s in tree_leaves(want)]
    assert len(got) == 169
    assert sum(int(np.prod(s)) for _, s in got) == D_FIXUP50
    # flax sorts keys as strings: block 10 before block 2
    names = [p.split("/")[1] for p, _ in got]
    assert names.index("FixupBottleneck_10") < names.index(
        "FixupBottleneck_2")


def test_small_fixup_layout_and_init_structure_follow_flax():
    """The small net's keys and shapes equal flax's; the port's init puts
    zeros exactly where flax's does (each branch's last conv, the head, the
    scalar biases), unit scales, and He kernels of flax's std; the logits
    at init are exactly 0 in both."""
    model, params = _fixup_init("float32")
    flax_leaves = tree_leaves(params)
    port_tree = init_fixup_resnet(3, **SMALL)
    port_leaves = tree_leaves(port_tree)
    assert [(p, tuple(np.shape(v))) for p, v in flax_leaves] == [
        (p, tuple(v.shape)) for p, v in port_leaves]
    assert [(p, tuple(s)) for p, s in tree_leaves(fixup_resnet_shapes(
        **SMALL))] == [(p, tuple(v.shape)) for p, v in port_leaves]
    assert sum(int(np.prod(np.shape(v))) for _, v in flax_leaves) == D_SMALL
    for (path, want), (_, got) in zip(flax_leaves, port_leaves):
        got = got.numpy()
        want = np.asarray(want)
        if not want.any():
            assert not got.any(), path
        elif path.endswith("scale"):
            np.testing.assert_array_equal(got, want)
        else:  # a He kernel: same truncated-normal std within sampling
            assert got.any(), path
            if want.size >= 1024:
                assert abs(got.std() / want.std() - 1) < 0.1, path
    x, _ = _inputs(32)
    assert not np.asarray(model.apply(params, jnp.asarray(x))).any()
    vec, unravel = ravel_params(port_tree)
    assert not fixup_resnet_apply(unravel(vec), torch.from_numpy(x),
                                  dtype=torch.float32).any()


@pytest.mark.parametrize("size", [32, 33])
def test_fixup_logits_loss_grad_match_flax_float32(size):
    """From perturbed params; odd and even spatial sizes hold the
    symmetric pads (7x7/2 pad 3, 3x3/2 pad 1, max pool 3x3/2 pad 1)."""
    model, params = _fixup_init("float32", size)
    params = perturbed(params)
    x, y = _inputs(size)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))
    vec, unravel = ravel_params(params)
    apply32 = functools.partial(fixup_resnet_apply, dtype=torch.float32)
    got = apply32(unravel(vec), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    lj, _, gj = _jax_loss_and_grad(model.apply, params, x, y)
    lt, _, gt = _torch_loss_and_grad(apply32, params, x, y)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)
    assert np.abs(gj).max() > 0


def test_fixup_mixed_precision_close_to_flax():
    """compute_dtype='mixed': bf16 convs and head, the biases, scale,
    residual, max pool and mean in f32 (JAX's bf16 + f32 -> f32)."""
    model, params = _fixup_init("bfloat16")
    params = perturbed(params)
    x, y = _inputs(32)
    lj, _, gj = _jax_loss_and_grad(model.apply, params, x, y)
    lt, _, gt = _torch_loss_and_grad(fixup_resnet_apply, params, x, y)
    np.testing.assert_allclose(lt, lj, rtol=2e-2)
    assert np.linalg.norm(gt - gj) < 0.15 * np.linalg.norm(gj)


def test_resnet9_one_channel_matches_flax():
    """FEMNIST's ResNet-9: 28x28x1 in, 62 classes, width 4, float32."""
    model = ResNet9(num_classes=62, width=4, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))
    assert [(p, tuple(np.shape(v))) for p, v in tree_leaves(
        to_numpy_tree(params))] == [(p, tuple(s)) for p, s in tree_leaves(
            resnet9_shapes(62, 4, in_channels=1))]
    assert [(p, tuple(v.shape)) for p, v in tree_leaves(init_resnet9(
        0, 62, 4, in_channels=1))] == [(p, tuple(s)) for p, s in tree_leaves(
            resnet9_shapes(62, 4, in_channels=1))]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 62, size=6).astype(np.int32)
    apply32 = functools.partial(resnet9_apply, dtype=torch.float32)
    lj, _, gj = _jax_loss_and_grad(model.apply, params, x, y)
    lt, _, gt = _torch_loss_and_grad(apply32, params, x, y)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)


def test_resnet9_full_width_femnist_size():
    """BASELINE #3's D: ResNet-9 on 1 channel, 62 classes."""
    d = sum(int(np.prod(s)) for _, s in tree_leaves(resnet9_shapes(
        62, 64, in_channels=1)))
    assert d == 6_598_654
    assert sum(int(np.prod(s)) for _, s in tree_leaves(resnet9_shapes(
        100, 64))) == 6_619_300


# --- four-round twins against the reference's round -------------------

N_ROUNDS = 4
LR = 0.1
TWIN = dict(num_clients=6, num_workers=3, num_devices=1, local_batch_size=4,
            weight_decay=5e-4, seed=5, compute_dtype="float32")


def model_twin(kw, ref_apply, port_apply, params, dataset, prep=None,
               port_prep=None, n_rounds=N_ROUNDS):
    """N_ROUNDS rounds of a reference session and a port session (the
    reference's initial state carried over) on the reference sampler's
    batches of ``dataset`` (a reference ``FedDataset``). Returns (want,
    got): losses and every FedState leaf, for ``_assert_state_twin``."""
    ref = RefSession(RefConfig(**kw), params,
                     jax_loss(ref_apply, prep=prep, compute_dtype="float32"))
    port = FederatedSession(Config(**kw, device="cpu"), params,
                            classification_loss(port_apply, prep=port_prep,
                                                compute_dtype="float32"))
    port.state = state_from_jax(_leaves(ref.state))
    assert port.bytes_per_round() == ref.bytes_per_round()
    sampler = RefSampler(dataset, num_workers=kw["num_workers"],
                         local_batch_size=port.cfg.sampler_batch_size,
                         seed=1)
    want, got = {"losses": []}, {"losses": []}
    for r in range(n_rounds):
        ids, batch = sampler.sample_round(r)
        batch = microbatched(port.cfg, batch)
        want["losses"].append(float(ref.train_round(ids, batch, LR)["loss"]))
        got["losses"].append(float(port.train_round(ids, batch, LR)["loss"]))
    want.update(_leaves(ref.state))
    got.update(state_to_jax(port.state))
    return want, got


FIXUP_TWINS = {
    "fedavg": dict(mode="fedavg", num_local_iters=2),
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=2000, num_rows=5, num_cols=40_000),
}


@pytest.mark.parametrize("case", sorted(FIXUP_TWINS))
def test_fixup_four_round_twin_matches_reference(case):
    """The small FixupResNet on uint8 ImageNet-normalized 32x32 images,
    from perturbed params (BASELINE #5's fedavg, and the FetchSGD flags)."""
    model, params = _fixup_init("float32")
    params = perturbed(params, seed=4, scale=0.05)
    rng = np.random.default_rng(6)
    data = {"x": rng.integers(0, 256, (96, 32, 32, 3)).astype(np.uint8),
            "y": rng.integers(0, 10, 96).astype(np.int32)}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*envelope")
        want, got = model_twin(
            {**TWIN, **FIXUP_TWINS[case]}, model.apply,
            functools.partial(fixup_resnet_apply, dtype=torch.float32),
            params, RefDataset(data, TWIN["num_clients"], seed=0),
            prep=device_normalizer(IMAGENET_MEAN, IMAGENET_STD),
            port_prep=normalizer(IMAGENET_MEAN, IMAGENET_STD))
    _assert_state_twin(got, want)
    assert want["losses"][0] != want["losses"][-1]

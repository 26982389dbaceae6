"""Tensor and sequence parallelism of the port (``parallel/tensor.py``,
``sequence.py``, ``ring_attention.py``, the grid of ``parallel/mesh.py``)
against the JAX reference, on the CPU.

The port runs one process per grid position, so its side runs on eight
gloo ranks, one spawn of ``tests/test_torch_gloo_worker.py`` (its ``tp``
job: every grid below is built over the same eight ranks) whose outputs
the tests share; the reference runs here on ``tests/conftest.py``'s eight
virtual CPU devices, each test computing its reference values before it
reads the spawn's. Inputs come from numpy seeds and the reference's
params and data, which cross over as numpy (``interop``). fp32
throughout:

1. ``tp_transform``/``untransform`` equal to the reference's, bitwise;
2. ring attention at seq 2 and 4, causal and not, and its q/k/v
   gradients against ``jax.vjp`` of the reference's
   ``ring_attention_sharded`` (rtol 1e-5 / atol 1e-5);
3. ``tp_gpt2_apply`` and ``sp_gpt2_apply`` on ``tests/
   test_tensor_parallel.py``'s ``CFG`` at model 2, seq 2 and model 2 x
   seq 2 against the reference's (rtol 1e-5 / atol 1e-5), and T not
   divisible by seq refused;
4. the loss and every leaf of ``build_tp_flat_loss``'s flat gradient,
   through ``make_grad_one`` vmapped over two clients and unbatched,
   against the reference's under its mesh and the port's dense gradient
   (rtol 1e-5 / atol 1e-6);
5. the reference's anchor ``test_federated_tp_sp_round_matches_dp_oracle``:
   four sketch rounds at workers 2 x model 2 x seq 2 against the
   reference's TP round and the port's dense oracle, every rank's
   ``params_vec`` bit-equal;
6. ``build_tp_eval_fn`` at (2, 2, 2), eval batch 4, against the
   reference's case of ``test_tp_eval_matches_dense_eval``;
7. ``build_tp3d_train_step``: one SGD step at (2, 2, 2), (4, 2, 1) and
   (2, 1, 4) against the dense SGD step of the reference's anchor
   ``test_tp3d_train_step_matches_single_device_sgd`` and, at (2, 2, 2),
   against the reference's own 3-axis step (loss atol 1e-5 and every
   leaf of every rank's shard atol 1e-6, tighter than the anchor's 2e-4
   and 5e-4);
8. the sketch-fused backward under the TP/SP loss at workers 2 x model 2
   x seq 2: round 0's gradient table, with weight decay, within ``1e-5 *
   max|table|`` of the dense gradient's sketch (monolithic and as the
   layerwise groups' sum), and four rounds, alone and with the layerwise
   overlap, every rank's ``params_vec`` bit-equal, held to the
   dense-grad TP round and to the one-process fused round as the anchor
   round is held.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.data import load_fed_personachat as ref_load
from commefficient_tpu.data.fed_dataset import FedDataset as RefFedDataset
from commefficient_tpu.models import GPT2DoubleHeads
from commefficient_tpu.models import gpt2_double_heads_loss as ref_gpt2_loss
from commefficient_tpu.models.gpt2 import GPT2Config as RefGPT2Config
from commefficient_tpu.ops.param_utils import ravel_params as ref_ravel
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.parallel import mask_gpt2 as ref_mask_gpt2
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.parallel.ring_attention import (
    ring_attention_sharded as ref_ring,
)
from commefficient_tpu.parallel.sequence import sp_gpt2_apply as ref_sp_apply
from commefficient_tpu.parallel.tensor import build_tp_eval_fn as ref_tp_eval
from commefficient_tpu.parallel.tensor import build_tp_flat_loss as ref_tp_loss
from commefficient_tpu.parallel.tensor import (
    build_tp3d_train_step as ref_tp3d_step,
)
from commefficient_tpu.parallel.tensor import tp_gpt2_apply as ref_tp_apply
from commefficient_tpu.parallel.tensor import tp_shard_params as ref_tp_shard
from commefficient_tpu.parallel.tensor import (
    tp_transform_params as ref_transform,
)
from commefficient_tpu.parallel.tensor import (
    tp_untransform_params as ref_untransform,
)
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu.utils.jax_compat import shard_map
from commefficient_tpu_torch.interop import params_from_jax
from commefficient_tpu_torch.models import (
    GPT2Config,
    gpt2_apply,
    gpt2_double_heads_loss,
    gpt2_shapes,
)
from commefficient_tpu_torch.ops.param_utils import make_unravel, tree_leaves
from commefficient_tpu_torch.parallel import FederatedSession, mask_gpt2
from commefficient_tpu_torch.parallel.mesh import SingleWorker
from commefficient_tpu_torch.parallel.round import make_grad_one
from commefficient_tpu_torch.parallel.sequence import sp_gpt2_apply
from commefficient_tpu_torch.parallel import build_tp3d_train_step
from commefficient_tpu_torch.parallel.tensor import (
    _local_blocks,
    build_tp_flat_loss,
    tp_gpt2_apply,
    tp_transform_params,
    tp_untransform_params,
)
from commefficient_tpu_torch.utils.config import Config
from test_tensor_parallel import CFG, T, _setup
from test_torch_gloo_worker import spawn

WORLD = 8
RING_SHAPE = (2, 4, T, 8)  # B, H, T, hd (tests/test_ring_attention.py's)
RING_CASES = [(4, 1, 2), (2, 1, 4)]  # seq 2 and seq 4
APPLY_GRIDS = [(4, 2, 1), (4, 1, 2), (2, 2, 2)]  # model 2, seq 2, both
ROUND_KW = dict(  # the reference anchor's, at model 2 x seq 2
    mode="sketch", error_type="virtual", virtual_momentum=0.9, k=200,
    num_rows=3, num_cols=10_000, num_epochs=1, num_clients=4,
    num_workers=2, num_devices=2, local_batch_size=2, max_seq_len=T,
    weight_decay=0.0, lr_scale=0.05, pivot_epoch=1, device_data=False)
ROUNDS, LR = 4, 0.05
EVAL_KW = dict(mode="uncompressed", num_epochs=1, num_clients=4,
               num_workers=2, num_devices=2, local_batch_size=2,
               max_seq_len=T, model_axis=2, seq_axis=2, device_data=False)
EVAL_BS = 4
TP3D_GRIDS = [(2, 2, 2), (4, 2, 1), (2, 1, 4)]
TP3D_LR = 0.1
# the fused rounds: the anchor's sketch rounds at f32 compute, fused
# clients, the fused backward
FUSED_KW = dict(ROUND_KW, model_axis=2, seq_axis=2, fuse_clients=True,
                sketch_fused_bwd=True)
FUSED_RUNS = ("fused", "layerwise", "dense")
FUSED_WD = 1e-2  # the table check's weight decay (joins once, after sums)


def _gkey(grid):
    return "x".join(map(str, grid))


def _port_cfg(ref_cfg) -> dict:
    return {k: getattr(ref_cfg, k) for k in (
        "vocab_size", "n_positions", "n_embd", "n_layer", "n_head")}


# the synthetic PersonaChat draws each client's tokens from a band of 200
# ids, so a base vocabulary below 200 (the reference anchor's 123) draws
# ids past the table: JAX clamps the gather and fills the CE's label
# gather with NaN, and the anchor's losses are NaN. 200 keeps every id in
# the table
BASE_VOCAB = 200


@functools.lru_cache(maxsize=None)
def fed():
    """The reference anchor's setup (at ``BASE_VOCAB``): the synthetic
    PersonaChat at T 64, the tiny GPT-2 at its vocabulary, params from
    ``jax.random.key(0)``, the sampler's four rounds (seed 3) and the test
    split."""
    train, test, _, vocab = ref_load(
        "./nonexistent", num_clients=4, num_candidates=2, max_history=2,
        max_seq_len=T, base_vocab=BASE_VOCAB, seed=0)
    gcfg = RefGPT2Config(vocab_size=vocab, n_positions=T, n_embd=CFG.n_embd,
                         n_layer=CFG.n_layer, n_head=CFG.n_head,
                         dtype=jnp.float32)
    model = GPT2DoubleHeads(gcfg)
    sample = next(iter(RefFedDataset(dict(train.data), 1,
                                     seed=0).eval_batches(1)))
    params = model.init(
        jax.random.key(0), jnp.asarray(sample["input_ids"][:1]),
        token_type_ids=jnp.asarray(sample["token_type_ids"][:1]),
        mc_token_ids=jnp.asarray(sample["mc_token_ids"][:1]))
    sampler = RefSampler(train, num_workers=2, local_batch_size=2, seed=3)
    rounds = [sampler.sample_round(r) for r in range(ROUNDS)]
    evals = [{k: np.asarray(v) for k, v in b.items()}
             for b in test.eval_batches(EVAL_BS)]
    return gcfg, model, params, rounds, evals, test


@functools.lru_cache(maxsize=None)
def tp3d_batch():
    """The reference anchor's batch (B 4, half of each row's labels
    masked, seed 7 MC labels) and its params."""
    _, params, ids, tt, mc = _setup(B=4)
    rng = np.random.default_rng(7)
    lm_labels = np.asarray(ids).copy()
    lm_labels[..., : T // 2] = -100
    batch = {"input_ids": np.asarray(ids), "token_type_ids": np.asarray(tt),
             "lm_labels": lm_labels, "mc_token_ids": np.asarray(mc),
             "mc_labels": rng.integers(0, 2, size=(4,)).astype(np.int32)}
    return params, batch


@functools.lru_cache(maxsize=None)
def ring_inputs():
    rng = np.random.default_rng(7)
    return tuple(rng.normal(size=RING_SHAPE).astype(np.float32)
                 for _ in range(4))  # q, k, v, the cotangent w


@functools.lru_cache(maxsize=None)
def job_and_arrays():
    gcfg, _, params, rounds, evals, _ = fed()
    _, a_params, ids, tt, mc = _setup()
    arrays = {
        "tp/apply_cfg/params": params_from_jax(
            jax.tree.map(np.asarray, a_params)).numpy(),
        "tp/fed_cfg/params": params_from_jax(
            jax.tree.map(np.asarray, params)).numpy(),
        "apply/ids": np.asarray(ids), "apply/tt": np.asarray(tt),
        "apply/mc": np.asarray(mc),
        "round/ids": np.stack([np.asarray(i) for i, _ in rounds]),
    }
    for name, x in zip("qkvw", ring_inputs()):
        arrays[f"ring/{name}"] = x
    for k in rounds[0][1]:
        arrays[f"round/{k}"] = np.stack([np.asarray(b[k])
                                         for _, b in rounds])
        arrays[f"loss/{k}"] = np.asarray(rounds[0][1][k])
    for i, b in enumerate(evals):
        for k, v in b.items():
            arrays[f"eval/{i}/{k}"] = v
    for k, v in tp3d_batch()[1].items():
        arrays[f"tp3d/{k}"] = v
    job = {"tp": {
        "apply_cfg": _port_cfg(CFG), "fed_cfg": _port_cfg(gcfg),
        "ring": [list(g) + [c] for g in RING_CASES for c in (1, 0)],
        "apply": [list(g) for g in APPLY_GRIDS],
        "loss": [list(g) for g in APPLY_GRIDS],
        "round": {"config": {**ROUND_KW, "model_axis": 2, "seq_axis": 2},
                  "compute_dtype": "mixed", "lr": LR},
        "eval": {"config": EVAL_KW, "batches": len(evals)},
        "tp3d": {"grids": [list(g) for g in TP3D_GRIDS], "lr": TP3D_LR},
        "fused_round": {"config": FUSED_KW, "lr": LR,
                        "runs": list(FUSED_RUNS), "weight_decay": FUSED_WD},
    }}
    return job, arrays


def eight_ranks(tmp_path_factory):
    job, arrays = job_and_arrays()
    return spawn(job, arrays, WORLD, tmp_path_factory, timeout=600)


def _port_gcfg(ref_cfg) -> GPT2Config:
    return GPT2Config(**_port_cfg(ref_cfg), dtype=torch.float32)


def _unravel(pcfg):
    return make_unravel(list(tree_leaves(gpt2_shapes(pcfg))))


def _leaves(pcfg, vec):
    """``(path, slice of vec)`` a leaf of the flat layout."""
    out, off = [], 0
    for path, shape in tree_leaves(gpt2_shapes(pcfg)):
        n = int(np.prod(shape))
        out.append((path, vec[off:off + n]))
        off += n
    return out


# -- 1. the transform -------------------------------------------------------


def test_tp_transform_and_untransform_equal_reference():
    _, params, *_ = _setup()
    pcfg = _port_gcfg(CFG)
    port = _unravel(pcfg)(params_from_jax(jax.tree.map(np.asarray, params)))
    want = ref_transform(params, CFG)
    got = tp_transform_params(port, pcfg)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in want_l:
        node = got
        for p in path:
            node = node[p.idx if hasattr(p, "idx") else p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=str(path))
    back = tp_untransform_params(got, pcfg)
    for (pa, a), (pb, b) in zip(tree_leaves(back), tree_leaves(port)):
        assert pa == pb and torch.equal(a, b)
    ref_back = ref_untransform(want, CFG)
    for (pa, a), (_, b) in zip(tree_leaves(back),
                               tree_leaves(jax.tree.map(np.asarray,
                                                        ref_back))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=pa)


# -- 2. ring attention ------------------------------------------------------


@pytest.mark.parametrize("causal", [1, 0], ids=["causal", "full"])
@pytest.mark.parametrize("grid", RING_CASES, ids=["seq2", "seq4"])
def test_ring_attention_and_its_gradients_match_reference(
        grid, causal, tmp_path_factory):
    q, k, v, w = (jnp.asarray(x) for x in ring_inputs())
    mesh = make_mesh(1, 1, grid[2])
    out, vjp = jax.vjp(jax.jit(functools.partial(
        ref_ring, mesh, causal=bool(causal))), q, k, v)
    want = [out, *vjp(w)]
    key = f"ring:{_gkey(grid)}:{causal}"
    for rank, got in enumerate(eight_ranks(tmp_path_factory)):
        for name, x in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[f"{key}/{name}"], np.asarray(x),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank} {name}")


# -- 3. the TP and SP forwards ----------------------------------------------


@pytest.mark.parametrize("grid", APPLY_GRIDS,
                         ids=["model2", "seq2", "model2_seq2"])
def test_tp_and_sp_forward_match_reference(grid, tmp_path_factory):
    model, params, ids, tt, mc = _setup()
    _, M, S = grid
    mesh = make_mesh(1, M, S)
    tp = ref_tp_shard(mesh, params, CFG)
    want = jax.jit(lambda p, a, b, c: ref_tp_apply(mesh, model, p, a, b, c))(
        tp, ids, tt, mc)
    want_sp = (jax.jit(lambda p, a, b, c: ref_sp_apply(
        make_mesh(1, 1, S), model, p, a, b, c))(params, ids, tt, mc)
        if S > 1 else None)
    key = _gkey(grid)
    for rank, got in enumerate(eight_ranks(tmp_path_factory)):
        for name, x in zip(("lm", "mc"), want):
            np.testing.assert_allclose(got[f"apply:{key}/{name}"],
                                       np.asarray(x), rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank} tp {name}")
        if want_sp is not None:
            for name, x in zip(("lm", "mc"), want_sp):
                np.testing.assert_allclose(got[f"sp:{key}/{name}"],
                                           np.asarray(x), rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=f"rank {rank} sp {name}")


class _Rank:
    """A stand-in group of ``size`` ranks, this one ``rank`` (the refusals
    come before any collective; the shard cut reads the two)."""

    def __init__(self, size, rank=0):
        self.rank, self.size = rank, size


def test_tp_and_sp_refuse_an_indivisible_sequence():
    _, params, *_ = _setup()
    pcfg = _port_gcfg(CFG)
    port = _unravel(pcfg)(params_from_jax(jax.tree.map(np.asarray, params)))
    grid = type("G", (), {"workers": SingleWorker(), "model": SingleWorker(),
                          "seq": _Rank(4)})()
    ids = torch.zeros((1, 1, T + 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="divide"):
        tp_gpt2_apply(grid, pcfg, tp_transform_params(port, pcfg), ids)
    with pytest.raises(ValueError, match="divide"):
        sp_gpt2_apply(grid.seq, pcfg, port, ids)
    loss_fn = build_tp_flat_loss(pcfg, grid)
    batch = {"input_ids": ids, "lm_labels": ids,
             "mc_token_ids": torch.zeros((1, 1), dtype=torch.int64),
             "mc_labels": torch.zeros((1,), dtype=torch.int64)}
    with pytest.raises(ValueError, match="divide"):
        loss_fn(port, batch)
    # the reference refuses the same
    with pytest.raises(ValueError, match="divide"):
        ref_tp_apply(make_mesh(1, 1, 4), _setup()[0], ref_tp_shard(
            make_mesh(1, 1, 4), params, CFG), jnp.asarray(ids.numpy()))


# -- 4. the loss and its flat gradient --------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_loss_grads():
    """The reference's ``(loss, aux, flat grad)`` of each of round 0's two
    clients under its workers 1 x model 2 x seq 2 mesh (its shard_map
    totals the shards' cotangents): the grids of one axis are held to the
    same, which is the dense gradient to the test's tolerance."""
    gcfg, _, params, rounds, _, _ = fed()
    mesh = make_mesh(1, 2, 2)
    loss_fn = ref_tp_loss(gcfg, mesh)

    def body(p, b):
        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        return loss, aux, ravel_pytree(g)[0]

    ref_fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P()),
                               out_specs=P()))
    return [ref_fn(params, {k: jnp.asarray(np.asarray(v)[c])
                            for k, v in rounds[0][1].items()})
            for c in range(2)]


@pytest.mark.parametrize("grid", APPLY_GRIDS,
                         ids=["model2", "seq2", "model2_seq2"])
def test_tp_flat_loss_gradient_matches_reference_and_dense(
        grid, tmp_path_factory):
    gcfg, _, params, rounds, _, _ = fed()
    batch = rounds[0][1]
    ref = _ref_loss_grads()
    pcfg = _port_gcfg(gcfg)
    unravel = _unravel(pcfg)
    vec = params_from_jax(jax.tree.map(np.asarray, params))
    dense = make_grad_one(Config(device="cpu", max_grad_norm=None,
                                 weight_decay=0.0),
                          gpt2_double_heads_loss(functools.partial(
                              gpt2_apply, cfg=pcfg)), unravel)
    dense_g = [dense(vec, {k: torch.from_numpy(np.asarray(v)[c])
                           for k, v in batch.items()}) for c in range(2)]
    key = f"loss:{_gkey(grid)}"
    ranks = eight_ranks(tmp_path_factory)
    for rank, got in enumerate(ranks):
        # the grid's totals leave every rank the same gradient, bit for bit
        for name in ("grad", "grad1"):
            assert np.array_equal(got[f"{key}/{name}"],
                                  ranks[0][f"{key}/{name}"]), (rank, name)
        rows = [(got[f"{key}/grad"][c], got[f"{key}/loss"][c], c)
                for c in range(2)]
        rows.append((got[f"{key}/grad1"], got[f"{key}/loss1"], 0))
        for g, loss, c in rows:
            want_loss, _, want_g = ref[c]
            np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(loss, float(dense_g[c][1]),
                                       rtol=1e-5, atol=1e-6)
            for (path, a), (_, b), (_, d) in zip(
                    _leaves(pcfg, g), _leaves(pcfg, np.asarray(want_g)),
                    _leaves(pcfg, dense_g[c][0].numpy())):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {rank} {path}")
                np.testing.assert_allclose(a, d, rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {rank} {path} "
                                           "against the dense gradient")
        for c in range(2):
            for a in ("lm_loss", "mc_loss", "correct", "count",
                      "lm_loss_sum", "token_count"):
                np.testing.assert_allclose(got[f"{key}/{a}"][c],
                                           float(ref[c][1][a]), rtol=1e-5,
                                           atol=1e-6, err_msg=a)


# -- 5. the reference's anchor round ----------------------------------------


def test_federated_tp_sp_round_matches_reference_and_dense_oracle(
        tmp_path_factory):
    gcfg, model, params, rounds, _, _ = fed()
    mesh = make_mesh(2, 2, 2)
    ref = RefSession(RefConfig(**ROUND_KW, model_axis=2, seq_axis=2),
                     params, ref_tp_loss(gcfg, mesh, compute_dtype="mixed"),
                     mesh=mesh,
                     eval_loss_fn=ref_gpt2_loss(model.apply,
                                                compute_dtype="mixed"),
                     mask_batch=ref_mask_gpt2)
    ref_losses = [float(np.asarray(ref.train_round(i, b, LR)["loss"]))
                  for i, b in rounds]
    ref_params = np.asarray(ref.state.params_vec)
    pcfg = _port_gcfg(gcfg)
    oracle = FederatedSession(
        Config(**{**ROUND_KW, "num_devices": 1}, device="cpu"),
        _unravel(pcfg)(params_from_jax(jax.tree.map(np.asarray, params))),
        gpt2_double_heads_loss(functools.partial(gpt2_apply, cfg=pcfg),
                               compute_dtype="mixed"),
        mask_batch=mask_gpt2)
    oracle_losses = [float(oracle.train_round(i, b, LR)["loss"])
                     for i, b in rounds]
    oracle_params = oracle.full_params_vec().numpy()
    ranks = eight_ranks(tmp_path_factory)
    for rank, got in enumerate(ranks):
        # every rank of every model/seq group holds the same params_vec
        assert np.array_equal(got["round/params"], ranks[0]["round/params"])
        assert np.array_equal(got["round/losses"], ranks[0]["round/losses"])
    losses, tp_params = ranks[0]["round/losses"], ranks[0]["round/params"]
    _held_like_the_anchor(losses, tp_params, ref_losses, ref_params,
                          "against the reference's TP round")
    _held_like_the_anchor(losses, tp_params, oracle_losses, oracle_params,
                          "against the dense oracle")


# -- 6. the TP eval ---------------------------------------------------------


def test_tp_eval_matches_reference(tmp_path_factory):
    gcfg, model, params, _, _, test = fed()
    mesh = make_mesh(2, 2, 2)
    cfg = RefConfig(**EVAL_KW)
    tp_sess = RefSession(
        cfg, params, ref_tp_loss(gcfg, mesh), mesh=mesh,
        eval_fn=ref_tp_eval(gcfg, mesh, ref_ravel(params)[1]),
        mask_batch=ref_mask_gpt2)
    want = tp_sess.evaluate(test.eval_batches(EVAL_BS))
    dense = RefSession(cfg.replace(model_axis=1, seq_axis=1), params,
                       ref_gpt2_loss(model.apply), mask_batch=ref_mask_gpt2)
    want_dense = dense.evaluate(test.eval_batches(EVAL_BS))
    for rank, got in enumerate(eight_ranks(tmp_path_factory)):
        keys = {k[len("eval/"):] for k in got if k.startswith("eval/")}
        assert keys == set(want), rank
        for k in want:
            np.testing.assert_allclose(float(got[f"eval/{k}"]), want[k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(float(got[f"eval/{k}"]),
                                       want_dense[k], rtol=2e-4, atol=2e-4,
                                       err_msg=k)


# -- 7. the 3-axis SGD step -------------------------------------------------


def _rank_coords(rank, grid):
    _, M, S = grid
    return rank // (M * S), (rank // S) % M, rank % S


def _rank_shard(full, pcfg, m, M):
    """A transformed tree (numpy leaves) cut to model rank ``m``'s slices,
    as ``(path, leaf)`` pairs."""
    tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), full)
    tree = {**tree, "blocks": _local_blocks(tree["blocks"], pcfg,
                                            _Rank(M, m))}
    return tree_leaves(tree)


@functools.lru_cache(maxsize=None)
def _tp3d_oracles():
    """The anchor's dense SGD step (its loss, lm loss and new params in
    the transformed layout) and the reference's 3-axis step at (2, 2, 2)
    (its metrics and new params)."""
    params, batch = tp3d_batch()
    model = _setup()[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.value_and_grad(
        ref_gpt2_loss(model.apply), has_aux=True)(params, jb)
    dense = jax.tree.map(lambda p, g: p - TP3D_LR * g, params, grads)
    mesh = make_mesh(2, 2, 2)
    new_tp, metrics = ref_tp3d_step(mesh, model)(
        ref_tp_shard(mesh, params, CFG), jb, jnp.float32(TP3D_LR))
    return ({"loss": float(loss), "lm_loss": float(aux["lm_loss"])},
            ref_transform(dense, CFG),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, new_tp))


@pytest.mark.parametrize("grid", TP3D_GRIDS,
                         ids=["w2_m2_s2", "w4_m2", "w2_s4"])
def test_tp3d_train_step_matches_dense_sgd_and_reference(
        grid, tmp_path_factory):
    dense_m, dense_tp, ref_m, ref_tp = _tp3d_oracles()
    pcfg = _port_gcfg(CFG)
    key = f"tp3d:{_gkey(grid)}"
    for rank, got in enumerate(eight_ranks(tmp_path_factory)):
        _, m, _ = _rank_coords(rank, grid)
        wants = [(dense_m, dense_tp, "dense SGD")]
        if grid == (2, 2, 2):
            wants.append((ref_m, ref_tp, "the reference's step"))
        for want_m, want_tp, what in wants:
            for k in ("loss", "lm_loss"):
                np.testing.assert_allclose(
                    float(got[f"{key}/{k}"]), want_m[k], atol=1e-5,
                    err_msg=f"rank {rank} {k} against {what}")
            leaves = _rank_shard(want_tp, pcfg, m, grid[1])
            assert {f"{key}/leaf/{p}" for p, _ in leaves} == {
                k for k in got if k.startswith(f"{key}/leaf/")}
            for path, leaf in leaves:
                np.testing.assert_allclose(
                    got[f"{key}/leaf/{path}"], leaf.numpy(), rtol=0,
                    atol=1e-6, err_msg=f"rank {rank} {path} against {what}")
        if grid == (2, 2, 2):
            np.testing.assert_allclose(float(got[f"{key}/mc_loss"]),
                                       ref_m["mc_loss"], atol=1e-5)


def test_tp3d_train_step_refuses_indivisible_batches():
    pcfg = _port_gcfg(CFG)
    grid = type("G", (), {"workers": _Rank(3), "model": SingleWorker(),
                          "seq": SingleWorker()})()
    step = build_tp3d_train_step(grid, pcfg)
    _, batch = tp3d_batch()
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="B=4 must divide by workers "
                       "axis 3"):
        step({}, batch, 0.1)
    grid.workers, grid.seq = SingleWorker(), _Rank(3)
    with pytest.raises(ValueError, match=f"T={T} must divide by seq "
                       "axis 3"):
        build_tp3d_train_step(grid, pcfg)({}, batch, 0.1)


# -- 8. the sketch-fused backward under the TP/SP loss ----------------------


def test_fused_tp_sp_table_matches_dense_gradient_sketch(tmp_path_factory):
    for rank, got in enumerate(eight_ranks(tmp_path_factory)):
        want = got["fused_table/dense"]
        tol = 1e-5 * np.abs(want).max()
        for name in ("fused", "layerwise"):
            np.testing.assert_allclose(got[f"fused_table/{name}"], want,
                                       rtol=0, atol=tol,
                                       err_msg=f"rank {rank} {name}")


def _held_like_the_anchor(losses, params, want_losses, want_params, what):
    """The anchor round's tolerances: losses rtol/atol 2e-4, at most 8
    params past ``2e-4 + 2e-3 * |want|`` and none past 1e-2 (a few top-k
    boundary flips are summation-order noise; a systematic gradient error
    flips thousands and moves the losses)."""
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=2e-4,
                               err_msg=what)
    diff = np.abs(params - want_params)
    flipped = diff > 2e-4 + 2e-3 * np.abs(want_params)
    assert int(flipped.sum()) <= 8, (
        f"{what}: {int(flipped.sum())} of {diff.size} params outside "
        f"tolerance (max abs diff {diff.max():.2e})")
    assert float(diff[flipped].max(initial=0.0)) < 1e-2, what


@functools.lru_cache(maxsize=None)
def _one_process_fused():
    gcfg, _, params, rounds, _, _ = fed()
    pcfg = _port_gcfg(gcfg)
    kw = {**FUSED_KW, "num_devices": 1, "model_axis": 1, "seq_axis": 1}
    sess = FederatedSession(
        Config(**kw, device="cpu"),
        _unravel(pcfg)(params_from_jax(jax.tree.map(np.asarray, params))),
        gpt2_double_heads_loss(functools.partial(gpt2_apply, cfg=pcfg)),
        mask_batch=mask_gpt2)
    losses = [float(sess.train_round(i, b, LR)["loss"]) for i, b in rounds]
    return np.asarray(losses), sess.full_params_vec().numpy()


@pytest.mark.parametrize("run", ["fused", "layerwise"])
def test_fused_tp_sp_round_matches_dense_tp_round_and_one_process(
        run, tmp_path_factory):
    one_losses, one_params = _one_process_fused()
    ranks = eight_ranks(tmp_path_factory)
    key = f"fused_round:{run}"
    for rank, got in enumerate(ranks):
        # every rank of every model/seq group holds the same params_vec
        assert np.array_equal(got[f"{key}/params"], ranks[0][f"{key}/params"])
        assert np.array_equal(got[f"{key}/losses"], ranks[0][f"{key}/losses"])
    losses, params = ranks[0][f"{key}/losses"], ranks[0][f"{key}/params"]
    _held_like_the_anchor(losses, params, ranks[0]["fused_round:dense/losses"],
                          ranks[0]["fused_round:dense/params"],
                          "against the dense-grad TP round")
    _held_like_the_anchor(losses, params, one_losses, one_params,
                          "against the one-process fused round")

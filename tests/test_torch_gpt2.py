"""The port's GPT-2 path (model, loss, decode, data, weight mapper, rounds
and entry point) against the JAX reference, on the CPU, at ``gpt2_tiny``.

Inputs are numpy arrays made from a seed; the reference's params (JAX
PRNG) are carried into the port as numpy. Tolerances, each with its
reason:

* the forward at ``float32``: ``atol 1e-5`` on logits of magnitude ~1
  (measured 2.4e-7; the two sum the products in another fp32 order);
* at ``mixed`` and ``bfloat16``: ``atol`` four bf16 ulps of the largest
  logit (``2^-6 * max|logit|``; measured ~1 ulp): the frameworks round
  the bf16 products, the GELU and the residual adds at other points;
* losses ``rtol 1e-5`` and gradients ``atol 1e-6`` at ``float32``;
* greedy decode tokens equal at ``float32``;
* the rounds (``compute_dtype float32``): losses ``rtol 1e-4``, params
  ``atol 1e-5``, the sketched momentum and error ``atol 1e-5 *
  max|table|`` (tests/test_torch_round.py's bounds: the port sums client
  gradients and buckets in another fp32 order); with bf16 tables and
  operands, the tables ``atol 2^-7 * max|table|``, two bf16 ulps at the
  table's largest entry (measured up to 0.51 of one): a client gradient
  that differs in its last fp32 bits can round to the neighbouring bf16
  operand, which moves its bucket by one ulp of the OPERAND, not of the
  (possibly cancelled, small) bucket sum, and the error feedback carries
  it on.
"""

import functools

import jax
from jax.flatten_util import ravel_pytree
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.data import FedSampler as RefSampler
from commefficient_tpu.data import personachat as ref_pc
from commefficient_tpu.models import hf_gpt2 as ref_hf
from commefficient_tpu.models.generate import generate as ref_generate
from commefficient_tpu.models.gpt2 import GPT2Config as RefGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads
from commefficient_tpu.models.gpt2 import manual_layer_norm as ref_manual_ln
from commefficient_tpu.models.losses import _cast_floats as ref_cast
from commefficient_tpu.models.losses import (
    gpt2_double_heads_loss as ref_gpt2_loss,
)
from commefficient_tpu.parallel import FederatedSession as RefSession
from commefficient_tpu.parallel import mask_gpt2 as ref_mask_gpt2
from commefficient_tpu.utils.config import Config as RefConfig
from commefficient_tpu_torch.data import FedSampler
from commefficient_tpu_torch.data import personachat as port_pc
from commefficient_tpu_torch.interop import params_from_jax, params_to_jax
from commefficient_tpu_torch.models import (
    GPT2Config,
    gpt2_apply,
    gpt2_double_heads_loss,
    gpt2_shapes,
    init_gpt2,
)
from commefficient_tpu_torch.models import hf_gpt2
from commefficient_tpu_torch.models.generate import generate
from commefficient_tpu_torch.models.gpt2 import manual_layer_norm
from commefficient_tpu_torch.models.losses import _cast_floats
from commefficient_tpu_torch.ops.param_utils import ravel_params, tree_leaves
from commefficient_tpu_torch.parallel import FederatedSession, mask_gpt2
from commefficient_tpu_torch.utils.config import Config

V = 517  # gpt2_tiny's 512 tokens + the 5 PersonaChat specials
TINY = dict(vocab_size=V, n_positions=128, n_embd=64, n_layer=2, n_head=4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "mixed": (jnp.bfloat16, torch.bfloat16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _few_threads():
    """The tiny model's products are launch-sized: on a shared CPU, many
    threads cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


@functools.lru_cache(maxsize=None)
def _case(compute: str, seed: int = 0):
    """(reference model, its params, port config, numpy inputs)."""
    jdt, tdt = DTYPES[compute]
    model = GPT2DoubleHeads(RefGPT2Config(**TINY, dtype=jdt))
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (2, 2, 16)).astype(np.int32)
    tt = rng.integers(512, V, (2, 2, 16)).astype(np.int32)
    mc = rng.integers(0, 16, (2, 2)).astype(np.int32)
    params = jax.jit(model.init)(jax.random.key(seed), ids,
                                 token_type_ids=tt, mc_token_ids=mc)
    return model, params, GPT2Config(**TINY, dtype=tdt), (ids, tt, mc)


@pytest.mark.parametrize("compute", sorted(DTYPES))
def test_forward_matches_reference(compute):
    """LM and MC logits of the flax model and the port, from the same
    params, at each compute type (``bfloat16`` also casts the params at
    the boundary, as the loss does)."""
    model, params, pcfg, (ids, tt, mc) = _case(compute)
    ref_p, port_p = params, _to_torch(params)
    if compute == "bfloat16":
        ref_p = ref_cast(params, jnp.bfloat16)
        port_p = _cast_floats(port_p, torch.bfloat16)
    lm, mcl = jax.jit(model.apply)(ref_p, ids, token_type_ids=tt,
                                   mc_token_ids=mc)
    lm, mcl = np.asarray(lm, np.float32), np.asarray(mcl, np.float32)
    with torch.no_grad():
        p_lm, p_mc = gpt2_apply(port_p, torch.from_numpy(ids),
                                torch.from_numpy(tt), torch.from_numpy(mc),
                                cfg=pcfg)
    assert p_lm.dtype == p_mc.dtype == torch.float32
    assert p_lm.shape == (2, 2, 16, V) and p_mc.shape == (2, 2)
    scale = max(float(np.abs(lm).max()), float(np.abs(mcl).max()))
    atol = 1e-5 if compute == "float32" else 2.0**-6 * scale
    np.testing.assert_allclose(p_lm.numpy(), lm, rtol=0, atol=atol)
    np.testing.assert_allclose(p_mc.numpy(), mcl, rtol=0, atol=atol)


def _batch(seed=1, B=2, N=2, T=16):
    """A GPT-2 batch whose LM labels are -100 on a prompt and padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, N, T)).astype(np.int32)
    labels = np.where(rng.random((B, N, T)) < 0.5, ids, -100).astype(np.int32)
    labels[:, 0] = -100  # only the last candidate is the true reply
    return {"input_ids": ids,
            "token_type_ids": rng.integers(512, V, (B, N, T)).astype(np.int32),
            "lm_labels": labels,
            "mc_token_ids": rng.integers(0, T, (B, N)).astype(np.int32),
            "mc_labels": np.full((B,), N - 1, np.int32)}


@pytest.mark.parametrize("compute", ["float32", "mixed"])
def test_loss_metrics_and_gradient_match_reference(compute):
    """The twin loss (next-token shift, token-weighted LM sum and count,
    MC correct and count) and, at float32, its gradient over the flat
    vector."""
    model, params, pcfg, _ = _case(compute)
    batch = _batch()
    ref_loss = ref_gpt2_loss(model.apply, 1.0, 0.5, compute_dtype=compute)
    port_loss = gpt2_double_heads_loss(
        functools.partial(gpt2_apply, cfg=pcfg), 1.0, 0.5,
        compute_dtype=compute)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (r_loss, r_aux), r_grad = jax.jit(jax.value_and_grad(
        lambda p: ref_loss(p, jb), has_aux=True))(params)
    vec, unravel = ravel_params(_to_torch(params))
    p = vec.requires_grad_(True)
    l_port, aux = port_loss(unravel(p), {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    (g,) = torch.autograd.grad(l_port, p)
    l_port = l_port.detach()
    rtol = 1e-5 if compute == "float32" else 2e-2
    np.testing.assert_allclose(float(l_port), float(r_loss), rtol=rtol)
    for k in ("lm_loss", "mc_loss", "lm_loss_sum"):
        np.testing.assert_allclose(float(aux[k]), float(r_aux[k]), rtol=rtol)
    for k in ("token_count", "count", "correct"):
        assert float(aux[k]) == float(r_aux[k]), k
    if compute == "float32":
        want = np.asarray(ravel_pytree(r_grad)[0])
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)


def test_manual_layer_norm_matches_reference():
    """The decode's LayerNorm (E[x^2] - mean^2, unclamped), bf16 in and
    out, and f32."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(ref_manual_ln(jnp.asarray(x).astype(jdt),
                                        {k: jnp.asarray(v)
                                         for k, v in p.items()}, 1e-5),
                          np.float32)
        got = manual_layer_norm(torch.from_numpy(x).to(tdt),
                                {k: torch.from_numpy(v)
                                 for k, v in p.items()}, 1e-5)
        assert got.dtype == tdt
        atol = 1e-5 if tdt == torch.float32 else 2.0**-6 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=atol)


def test_generate_greedy_matches_reference():
    """KV-cache greedy decode with token types, a new-token type and an
    eos, at float32: the same tokens."""
    model, params, pcfg, _ = _case("float32")
    rcfg = RefGPT2Config(**TINY, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 512, (2, 7)).astype(np.int32)
    tt = rng.integers(512, V, (2, 7)).astype(np.int32)
    kw = dict(new_token_type=515, eos_token_id=int(ids[0, 3]))
    want = np.asarray(ref_generate(rcfg, params, jnp.asarray(ids), 9,
                                   token_type_ids=jnp.asarray(tt), **kw))
    got = generate(pcfg, _to_torch(params), torch.from_numpy(ids), 9,
                   token_type_ids=torch.from_numpy(tt), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    no_eos = generate(pcfg, _to_torch(params), torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(no_eos.numpy(), np.asarray(ref_generate(
        rcfg, params, jnp.asarray(ids), 4)))


def test_personachat_draws_equal_reference():
    """The synthetic corpus, the candidate assembly, the per-client split
    and the sampler's rounds: the reference's arrays for the same seed."""
    kw = dict(num_clients=5, num_candidates=3, max_history=2,
              max_seq_len=48, base_vocab=512, seed=7)
    ref = ref_pc.load_fed_personachat("/nonexistent", **kw)
    port = port_pc.load_fed_personachat("/nonexistent", **kw)
    assert port[2:] == ref[2:] == (False, 517)
    for a, b in zip(ref[:2], port[:2]):
        assert b.num_clients == a.num_clients and len(b) == len(a)
        for k in a.data:
            np.testing.assert_array_equal(b.data[k], a.data[k])
        for ia, ib in zip(a.client_indices, b.client_indices):
            np.testing.assert_array_equal(ib, ia)
    assert port_pc.SPECIAL_TOKENS == ref_pc.SPECIAL_TOKENS
    assert port_pc.special_ids(512) == ref_pc.special_ids(512)
    rs = RefSampler(ref[0], num_workers=3, local_batch_size=2, seed=9)
    ps = FedSampler(port[0], num_workers=3, local_batch_size=2, seed=9)
    assert ps.steps_per_epoch() == rs.steps_per_epoch()
    for r in range(3):
        ids, batch = rs.sample_round(r)
        ids_p, batch_p = ps.sample_round(r)
        np.testing.assert_array_equal(ids_p, ids)
        for k in batch:
            np.testing.assert_array_equal(batch_p[k], batch[k])


def _hf_state_dict(cfg, hf_vocab, seed=0):
    """An HF GPT2DoubleHeadsModel-named state dict, built here (never
    downloaded): Conv1D weights are [in, out]."""
    g = torch.Generator().manual_seed(seed)
    E = cfg["n_embd"]
    sd = {"transformer.wte.weight": torch.randn(hf_vocab, E, generator=g),
          "transformer.wpe.weight": torch.randn(cfg["n_positions"], E,
                                                generator=g),
          "transformer.ln_f.weight": torch.randn(E, generator=g),
          "transformer.ln_f.bias": torch.randn(E, generator=g)}
    for i in range(cfg["n_layer"]):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = torch.randn(E, generator=g)
            sd[p + ln + ".bias"] = torch.randn(E, generator=g)
        for name, (a, b) in (("attn.c_attn", (E, 3 * E)),
                             ("attn.c_proj", (E, E)),
                             ("mlp.c_fc", (E, 4 * E)),
                             ("mlp.c_proj", (4 * E, E))):
            sd[p + name + ".weight"] = torch.randn(a, b, generator=g)
            sd[p + name + ".bias"] = torch.randn(b, generator=g)
    return sd


def test_hf_mapper_matches_reference_and_round_trips(tmp_path):
    """A state dict built here maps into the port's tree as into the
    reference's (the special-token rows past the checkpoint's vocabulary
    keep the fresh init); ``save_pretrained`` writes torch's format, which
    the mapper reads back to the same tree."""
    _, params, pcfg, _ = _case("float32")
    sd = _hf_state_dict(TINY, hf_vocab=512)
    ck = tmp_path / "ck"
    ck.mkdir()
    torch.save(sd, ck / "pytorch_model.bin")
    want, loaded = ref_hf.load_hf_gpt2_params(
        str(ck), RefGPT2Config(**TINY), params)
    got, loaded_p = hf_gpt2.load_hf_gpt2_params(str(ck), pcfg,
                                                _to_torch(params))
    assert loaded and loaded_p
    for (pa, a), (pb, b) in zip(tree_leaves(want), tree_leaves(got)):
        assert pa == pb
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    wte = got["params"]["transformer"]["wte"]
    np.testing.assert_array_equal(
        wte[512:].numpy(),
        np.asarray(params["params"]["transformer"]["wte"])[512:])
    assert hf_gpt2.load_hf_gpt2_params(str(tmp_path / "none"), pcfg,
                                       got)[1] is False
    out = tmp_path / "saved"
    hf_gpt2.save_pretrained(str(out), pcfg, got)
    assert (out / "config.json").exists()
    back, ok = hf_gpt2.load_hf_gpt2_params(
        str(out), pcfg, init_gpt2(pcfg, seed=1))
    assert ok
    for (pa, a), (pb, b) in zip(tree_leaves(got["params"]["transformer"]),
                                tree_leaves(back["params"]["transformer"])):
        assert pa == pb and torch.equal(a, b), pa


def test_gpt2_tree_layout_and_interop_round_trip():
    """The port's GPT-2 leaves are the reference's, in ``ravel_pytree``
    order (``h_10`` before ``h_2`` at 12 layers), and the flat vector
    crosses ``interop`` both ways bit for bit."""
    _, params, pcfg, _ = _case("float32")
    ref_leaves = [(p, tuple(np.shape(a))) for p, a in tree_leaves(params)]
    assert ref_leaves == [(p, s) for p, s in tree_leaves(gpt2_shapes(pcfg))]
    init = init_gpt2(pcfg, seed=3)
    assert [(p, tuple(t.shape)) for p, t in tree_leaves(init)] == ref_leaves
    vec = params_from_jax(params)
    want = np.asarray(ravel_pytree(params)[0])
    np.testing.assert_array_equal(vec.numpy(), want)
    back = params_to_jax(vec, params)
    for (_, a), (_, b) in zip(tree_leaves(back), tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    names = [p for p, _ in tree_leaves(gpt2_shapes(GPT2Config()))]
    assert names.index("params/transformer/h_10/attn/c_attn/bias") < \
        names.index("params/transformer/h_2/attn/c_attn/bias")
    D = sum(int(np.prod(s)) for _, s in tree_leaves(gpt2_shapes(
        GPT2Config(vocab_size=50262))))
    assert D == 124_444_417  # GPT-2 small with the 5 special tokens


# -- rounds ---------------------------------------------------------------------

ROUND_BASE = dict(model="gpt2_tiny", dataset_name="personachat",
                  num_clients=4, num_workers=2, num_devices=1,
                  local_batch_size=2, max_seq_len=32, compute_dtype="float32",
                  max_grad_norm=1.0, weight_decay=0.0, seed=3)
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=500, num_rows=3, num_cols=20_000)
ROUNDS = {
    "sketch_f32_tables": SKETCH,
    "sketch_bf16_tables_and_operands": dict(
        SKETCH, sketch_table_dtype="bfloat16", sketch_dtype="bfloat16"),
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9),
}


def _twin_sessions(kw):
    from commefficient_tpu.train import gpt2_train as ref_train

    ref_cfg = RefConfig(**ROUND_BASE, **kw)
    train, _, _, _, rgcfg, model, params, ref_loss = (
        ref_train.build_model_and_data(ref_cfg))
    ref = RefSession(ref_cfg, params, ref_loss, mask_batch=ref_mask_gpt2)
    pcfg = GPT2Config(vocab_size=rgcfg.vocab_size,
                      n_positions=rgcfg.n_positions, n_embd=rgcfg.n_embd,
                      n_layer=rgcfg.n_layer, n_head=rgcfg.n_head,
                      dtype=torch.float32)
    port = FederatedSession(
        Config(**ROUND_BASE, **kw, device="cpu"), _to_torch(params),
        gpt2_double_heads_loss(functools.partial(gpt2_apply, cfg=pcfg)),
        mask_batch=mask_gpt2)
    return ref, port, train


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_three_rounds_match_reference(case):
    """Three rounds of a reference session and a port session from the
    same params and batches: losses, params and every other FedState
    leaf (the sketched momentum and error in their storage type)."""
    kw = ROUNDS[case]
    ref, port, train = _twin_sessions(kw)
    assert port.grad_size == ref.grad_size
    assert port.bytes_per_round() == ref.bytes_per_round()
    sampler = RefSampler(train, num_workers=2, local_batch_size=2, seed=3)
    l_ref, l_port = [], []
    for r in range(3):
        ids, batch = sampler.sample_round(r)
        l_ref.append(float(ref.train_round(ids, batch, 0.1)["loss"]))
        l_port.append(float(port.train_round(ids, batch, 0.1)["loss"]))
    np.testing.assert_allclose(l_port, l_ref, rtol=1e-4)
    np.testing.assert_allclose(port.state.params_vec.numpy(),
                               np.asarray(ref.state.params_vec), rtol=0,
                               atol=1e-5)
    assert port.state.step == int(ref.state.step) == 3
    bf16 = case == "sketch_bf16_tables_and_operands"
    for name in ("momentum", "error"):
        want = np.asarray(getattr(ref.state, name))
        leaf = getattr(port.state, name)
        if case == "uncompressed":
            if name == "momentum":
                np.testing.assert_allclose(leaf.numpy(), want, rtol=0,
                                           atol=1e-5)
            continue
        assert leaf.dtype == (torch.bfloat16 if bf16 else torch.float32)
        got = leaf.float().numpy()
        want = want.astype(np.float32)
        if bf16:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2.0**-7 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(
                np.abs(want).max(), 1))


def test_eval_metrics_match_reference_under_a_ragged_batch():
    """``evaluate`` sums the token-weighted ``lm_loss_sum`` /
    ``token_count`` pair and masks the padded rows of a ragged last batch
    (``mask_gpt2``), as the reference's session does."""
    from commefficient_tpu.train.gpt2_train import evaluate_ppl as ref_ppl
    from commefficient_tpu_torch.train.gpt2_train import evaluate_ppl

    ref, port, _ = _twin_sessions(ROUNDS["uncompressed"])
    _, test, _, _ = ref_pc.load_fed_personachat(
        "/nonexistent", num_clients=5, max_seq_len=32, base_vocab=512,
        seed=3)
    assert len(test) % 3 != 0  # the last batch of 3 is ragged
    want = ref_ppl(ref, test, 3)
    got = evaluate_ppl(port, test, 3)
    for k in ("nll", "ppl", "loss", "mc_accuracy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_gpt2_train_main_smoke_on_cpu(tmp_path):
    """The entry point a user calls, on the plain CPU path at gpt2_tiny:
    two rounds of FetchSGD, the nll / ppl / MC evaluation and a sample
    decode."""
    from commefficient_tpu_torch.train import gpt2_train

    out = gpt2_train.main([
        "--model", "gpt2_tiny", "--mode", "sketch", "--k", "500",
        "--num_rows", "3", "--num_cols", "20000", "--virtual_momentum",
        "0.9", "--error_type", "virtual", "--num_clients", "4",
        "--num_workers", "2", "--local_batch_size", "2", "--max_seq_len",
        "32", "--max_rounds", "2", "--dataset_dir", str(tmp_path),
        "--device", "cpu"])
    assert out["grad_size"] == 141_441 and out["real"] is False
    assert out["hf_weights"] is False
    assert len(out["history"]) == 2
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    assert out["param_delta_norm"] > 0
    assert np.isfinite(out["nll"]) and out["ppl"] > 1
    assert 0.0 <= out["mc_accuracy"] <= 1.0
    prompt, gen = out["samples"][-1]
    assert len(prompt) > 0 and len(gen) == 24
    # the [3, 19,952] f32 table
    assert out["bytes_per_round"]["upload_bytes"] == 4 * 3 * 19_952


_EXPORT_ARGS = [
    "--model", "gpt2_tiny", "--mode", "sketch", "--k", "500",
    "--num_rows", "3", "--num_cols", "20000", "--virtual_momentum", "0.9",
    "--error_type", "virtual", "--num_clients", "4", "--num_workers", "2",
    "--local_batch_size", "2", "--max_seq_len", "32", "--max_rounds", "2",
    "--device", "cpu"]


def test_gpt2_train_exports_hf_format_and_keeps_state_under_state(tmp_path):
    """As the reference's gpt2_train (its tests/test_gpt2_train.py pins
    ``config.json``): a finished run writes the HF-format export at the top
    of ``--checkpoint_dir`` (``config.json`` with the base vocabulary plus
    the 5 special tokens, ``pytorch_model.bin``) and its full-state
    checkpoints under ``state/``; the export reads back through
    ``load_hf_gpt2_params`` (and its MC head from the file) bit-equal to
    the run's final params. A
    preempted run exits 75 with its state saved and writes no export."""
    import json

    from commefficient_tpu_torch.resilience import EXIT_PREEMPTED
    from commefficient_tpu_torch.train import gpt2_train
    from commefficient_tpu_torch.utils.config import parse_args

    ck = tmp_path / "ck"
    args = _EXPORT_ARGS + ["--dataset_dir", str(tmp_path)]
    out = gpt2_train.main(args + ["--checkpoint_dir", str(ck)])
    assert out["final_step"] == 2
    assert (ck / "config.json").is_file()
    assert (ck / "pytorch_model.bin").is_file()
    assert json.loads((ck / "config.json").read_text())["vocab_size"] == \
        512 + 5
    assert sorted(p.name for p in (ck / "state").glob("step_*.pt")) == \
        ["step_2.pt"]
    assert not list(ck.glob("step_*.pt"))
    state = torch.load(ck / "state" / "step_2.pt", map_location="cpu",
                       weights_only=True)["fed_state"]
    cfg = parse_args(args, defaults=gpt2_train.DEFAULTS)
    _, _, _, _, gcfg, template, _ = gpt2_train.build_model_and_data(cfg)
    loaded, ok = hf_gpt2.load_hf_gpt2_params(str(ck), gcfg, template)
    assert ok
    # the mapper reads the transformer (a pretrained checkpoint's part) and
    # keeps the caller's MC head; the export holds the run's head too
    sd = torch.load(ck / "pytorch_model.bin", weights_only=True)
    mc = loaded["params"]["mc_head"]
    mc["kernel"] = sd["multiple_choice_head.summary.weight"].T
    mc["bias"] = sd["multiple_choice_head.summary.bias"]
    vec = ravel_params(loaded)[0]
    assert torch.equal(vec, state["params_vec"][:vec.numel()])
    assert not torch.equal(vec, ravel_params(template)[0])  # it trained

    pre = tmp_path / "pre"
    with pytest.raises(SystemExit) as ei:
        gpt2_train.main(args + ["--checkpoint_dir", str(pre), "--chaos",
                                "preempt@1"])
    assert ei.value.code == EXIT_PREEMPTED
    assert list((pre / "state").glob("step_*.pt"))
    assert not (pre / "config.json").exists()
    assert not (pre / "pytorch_model.bin").exists()

"""gpt2_train — the GPT-2 workload entry point of the port (the paper's
second workload; the reference's ``train/gpt2_train.py``).

GPT-2 small with the double heads (LM + multiple choice), trained
federated on PersonaChat (one persona a client; the synthetic stand-in
when ``personachat_self_original.json`` is not in ``--dataset_dir``) with
the twin loss ``lm_coef * CE_lm + mc_coef * CE_mc``; the evaluation
reports the token-weighted nll, its perplexity and the MC accuracy, and
each epoch decodes a sample continuation of a held-out dialog. Same flags
as the reference's entry point, over its defaults (``--model gpt2
--dataset_name personachat --local_batch_size 4 --lr_scale 0.16
--max_grad_norm 1.0``), plus ``--device`` and ``--max_rounds``.

BASELINE config #4 (FetchSGD at GPT-2 scale, D = 124,444,417, a [5,
5,000,688] table) on one H100:

  python -m commefficient_tpu_torch.train.gpt2_train --mode sketch \\
      --k 50000 --num_rows 5 --num_cols 5000000 --virtual_momentum 0.9 \\
      --error_type virtual --compute_dtype bfloat16 --num_workers 8 \\
      --num_devices 1

``--sketch_table_dtype bfloat16`` halves the table (the upload, 100 MB ->
50 MB); ``--sketch_dtype bfloat16`` rounds the sketch's operands to bf16.
The sketch-fused backward needs the fused path, which the clip excludes:
``--max_grad_norm none --fuse_clients true --sketch_fused_bwd true``.
On the CPU, at the tests' size:

  python -m commefficient_tpu_torch.train.gpt2_train --model gpt2_tiny \\
      --num_clients 4 --num_workers 2 --local_batch_size 2 \\
      --max_seq_len 64 --num_epochs 1 --device cpu

Real GPT-2 weights are mapped in from ``--model_checkpoint`` (a directory
holding ``pytorch_model.bin``) when it exists; otherwise the model starts
from its seeded random init (``hf_weights=False`` in the first line).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from commefficient_tpu_torch.data import FedSampler, load_fed_personachat
from commefficient_tpu_torch.data.personachat import (
    SPECIAL_TOKENS,
    special_ids,
)
from commefficient_tpu_torch.models import (
    IGNORE_INDEX,
    GPT2Config,
    gpt2_apply,
    gpt2_double_heads_loss,
    gpt2_tiny_config,
    init_gpt2,
    model_dtype,
)
from commefficient_tpu_torch.models.generate import generate
from commefficient_tpu_torch.models.hf_gpt2 import load_hf_gpt2_params
from commefficient_tpu_torch import native
from commefficient_tpu_torch.control import controller_header
from commefficient_tpu_torch.parallel import FederatedSession, mask_gpt2
from commefficient_tpu_torch.parallel.mesh import distributed_from_env
from commefficient_tpu_torch.train.runner import WorkloadHooks, run_train_loop
from commefficient_tpu_torch.utils.config import Config, parse_args
from commefficient_tpu_torch.utils.logging import MetricsWriter, make_logdir

# the reference entry point's defaults over Config's
DEFAULTS = dict(model="gpt2", dataset_name="personachat", local_batch_size=4,
                lr_scale=0.16, max_grad_norm=1.0)


def gpt2_config(cfg: Config, vocab: int) -> GPT2Config:
    """GPT-2 small (``gpt2``, with the real GPT-2 vocabulary even on the
    synthetic data, so D ~ 124M) or the tests' ``gpt2_tiny``, at the
    PersonaChat vocabulary and ``n_positions >= max_seq_len``."""
    mdt = model_dtype(cfg.compute_dtype)
    if cfg.model == "gpt2":
        return GPT2Config(vocab_size=vocab,
                          n_positions=max(1024, cfg.max_seq_len), dtype=mdt)
    if cfg.model == "gpt2_tiny":
        tiny = gpt2_tiny_config()
        return GPT2Config(vocab_size=vocab,
                          n_positions=max(tiny.n_positions, cfg.max_seq_len),
                          n_embd=tiny.n_embd, n_layer=tiny.n_layer,
                          n_head=tiny.n_head, dtype=mdt)
    raise ValueError(f"unknown gpt2 model {cfg.model!r} (gpt2 | gpt2_tiny)")


def build_model_and_data(cfg: Config):
    """``(train, test, is_real, hf_loaded, gcfg, params, loss_fn)``:
    PersonaChat with the special-token vocabulary, GPT-2 at it."""
    base_vocab = 50257 if cfg.model == "gpt2" else 512
    train, test, real, vocab = load_fed_personachat(
        cfg.dataset_dir, num_clients=cfg.num_clients,
        num_candidates=cfg.num_candidates, max_history=cfg.max_history,
        max_seq_len=cfg.max_seq_len, base_vocab=base_vocab, seed=cfg.seed)
    gcfg = gpt2_config(cfg, vocab)
    params = init_gpt2(gcfg, cfg.seed)
    params, loaded = load_hf_gpt2_params(cfg.model_checkpoint, gcfg, params,
                                         seed=cfg.seed)
    loss_fn = gpt2_double_heads_loss(
        functools.partial(gpt2_apply, cfg=gcfg), cfg.lm_coef, cfg.mc_coef,
        compute_dtype=cfg.compute_dtype)
    return train, test, real, loaded, gcfg, params, loss_fn


def evaluate_ppl(session: FederatedSession, test_ds, batch_size: int):
    """The reference's eval metrics: the nll (TOKEN weighted: the summed
    masked-token NLL over the masked tokens), its perplexity, the MC
    accuracy and the mean loss."""
    out = session.evaluate(test_ds.eval_batches(batch_size))
    if out.get("token_count", 0.0) > 0:
        nll = out["lm_loss_sum"] / out["token_count"]
    else:
        nll = out.get("lm_loss", out["loss"])
    return {"nll": nll, "ppl": float(np.exp(min(nll, 20.0))),
            "mc_accuracy": out.get("accuracy", float("nan")),
            "loss": out["loss"]}


def sample_generation(session: FederatedSession, gcfg: GPT2Config, test_ds,
                      base_vocab: int, max_new: int = 24):
    """A greedy continuation of a held-out dialog (the reference's
    periodic generation): the gold candidate cut at its reply, decoded
    with the ``<speaker2>`` token type until ``<eos>``. Returns
    ``(prompt_ids, generated_ids)`` as numpy int arrays (token ids: text
    needs the real tokenizer)."""
    sp = special_ids(base_vocab)
    b = next(iter(test_ds.eval_batches(1)))
    mc = int(np.asarray(b["mc_labels"])[0])
    row = np.asarray(b["input_ids"])[0, mc]
    lab = np.asarray(b["lm_labels"])[0, mc]
    tt = np.asarray(b["token_type_ids"])[0, mc]
    nonmasked = np.nonzero(lab != IGNORE_INDEX)[0]
    cut = int(nonmasked[0]) if len(nonmasked) else row.shape[0] // 2
    # keep the prompt and its continuation inside n_positions
    trim = max(0, cut + max_new - gcfg.n_positions)
    prompt_ids, prompt_tt = row[trim:cut], tt[trim:cut]
    dev = session.device
    out = generate(gcfg, session.params,
                   torch.from_numpy(prompt_ids[None].astype(np.int64)).to(dev),
                   max_new,
                   token_type_ids=torch.from_numpy(
                       prompt_tt[None].astype(np.int64)).to(dev),
                   new_token_type=sp["<speaker2>"],
                   eos_token_id=sp["<eos>"])
    return prompt_ids, out[0, len(prompt_ids):].cpu().numpy()


class _Gpt2Hooks(WorkloadHooks):
    """The GPT-2 workload's plug-ins for the runner: the lm/mc loss
    accumulation, the nll/ppl evaluation, the console row and the
    per-epoch sample generation (kept in ``samples``)."""

    def __init__(self, cfg, session, test_ds, eval_batch_size, gcfg):
        self.cfg = cfg
        self.session = session
        self.test_ds = test_ds
        self.eval_batch_size = eval_batch_size
        self.gcfg = gcfg
        self.samples = []

    def new_accumulator(self):
        return {"loss": 0.0, "lm": 0.0, "mc": 0.0}

    def accumulate(self, acc, loss, metrics):
        W = self.cfg.num_workers
        acc["loss"] += loss
        # the lm/mc aux are sums over the W clients of their means
        acc["lm"] += float(metrics.get("lm_loss", 0.0)) / W
        acc["mc"] += float(metrics.get("mc_loss", 0.0)) / W

    def evaluate(self):
        return evaluate_ppl(self.session, self.test_ds, self.eval_batch_size)

    def write_val(self, writer, val, step):
        writer.scalar("val/nll", val["nll"], step)
        writer.scalar("val/ppl", val["ppl"], step)
        writer.scalar("val/mc_acc", val["mc_accuracy"], step)

    def epoch_row(self, *, epoch, lr, acc, val, train_time, val_time,
                  rounds):
        return {"epoch": epoch + 1, "lr": lr,
                "train_loss": acc["loss"] / rounds,
                "train_lm": acc["lm"] / rounds,
                "train_mc": acc["mc"] / rounds, "val_nll": val["nll"],
                "val_ppl": val["ppl"], "val_mc_acc": val["mc_accuracy"],
                "train_time": train_time, "val_time": val_time}

    def on_epoch_end(self, epoch, val):
        prompt, gen = sample_generation(
            self.session, self.gcfg, self.test_ds,
            base_vocab=self.gcfg.vocab_size - len(SPECIAL_TOKENS))
        self.samples.append((prompt, gen))
        print(f"  sample (epoch {epoch + 1}): ...{prompt[-8:].tolist()} -> "
              f"{gen.tolist()}", flush=True)


def main(argv=None, eval_batch_size: int = 8, **overrides):
    """Train and evaluate. Returns the final val metrics (``nll``,
    ``ppl``, ``mc_accuracy``, ``loss``) plus ``history`` (per-round
    step/lr/loss/ms), ``grad_size``, ``bytes_per_round``,
    ``param_delta_norm``, ``sketch_decode``, ``checkpoint`` (the runner's
    checkpoint facts), ``final_step``, ``samples`` (each epoch's
    ``(prompt, generated)`` token ids), ``hf_weights``, ``real``,
    ``data_path``, ``pipeline_stats`` (the pipelined engine's ``stats()``
    at ``--pipeline_depth`` > 0, else None) and ``logdir`` (rank 0's run
    dir: ``metrics.jsonl``, and the telemetry artifacts of
    ``--telemetry_level``, as cv_train) and ``control`` (the control
    plane's controller ``snapshot()``, None without it). Under
    ``torchrun`` with ``--num_devices N`` each process is one rank; rank 0
    alone evaluates and prints."""
    cfg = parse_args(argv, defaults=DEFAULTS, **overrides)
    if cfg.model not in ("gpt2", "gpt2_tiny"):
        raise ValueError(f"gpt2_train trains gpt2 | gpt2_tiny, got model="
                         f"{cfg.model!r}")
    with distributed_from_env(cfg):
        return _train(cfg, eval_batch_size)


def _train(cfg: Config, eval_batch_size: int):
    train, test, real, hf_loaded, gcfg, params, loss_fn = (
        build_model_and_data(cfg))
    session = FederatedSession(cfg, params, loss_fn, mask_batch=mask_gpt2)
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size,
                         seed=cfg.seed)
    # the token arrays live on the device when they fit; rounds ship only
    # [W, B] indices
    session.maybe_attach_data(train, sampler)
    say = print if session.group.rank == 0 else (lambda *a, **k: None)
    say(f"dataset=personachat (real={real}) model={cfg.model} "
        f"(V={gcfg.vocab_size}, L={gcfg.n_layer}, E={gcfg.n_embd}, "
        f"hf_weights={hf_loaded}) mode={cfg.mode} "
        f"clients={train.num_clients} workers={cfg.num_workers} "
        f"devices={session.group.size} device={session.device} "
        f"decode={session.sketch_decode_resolved} "
        f"aggregate={session.aggregate_resolved} data={session.data_path} "
        f"native={'yes' if native.available() else 'no'} "
        f"pipeline_depth={cfg.pipeline_depth}")
    if not real:
        say("WARNING: personachat json not found — synthetic stand-in "
            "(pipeline-correct; metrics are not paper numbers)")
    bpr = session.bytes_per_round()
    say(f"grad_size D={session.grad_size}  upload/client/round="
        f"{bpr['upload_bytes']:,} B  download={bpr['download_bytes']:,} B")
    hooks = _Gpt2Hooks(cfg, session, test, eval_batch_size, gcfg)
    p0 = session.full_params_vec().clone()
    pipeline_stats = {}
    writer = (MetricsWriter(make_logdir(cfg), cfg.tensorboard, cfg=cfg,
                            extra_header=controller_header(session))
              if session.group.rank == 0 else None)
    try:
        val, history, ckpt = run_train_loop(
            cfg, session, sampler, hooks,
            on_round=lambda r: print(
                f"round {r['step']}: lr={r['lr']:.6f} loss={r['loss']:.6f} "
                f"ms={r['ms']:.2f}", flush=True),
            engine_stats=pipeline_stats, writer=writer,
            generated_by="commefficient_tpu_torch.train.gpt2_train")
    finally:
        if writer is not None:
            writer.close()
    if val:
        say(f"final: val_nll={val['nll']:.4f} ppl={val['ppl']:.2f} "
            f"mc_acc={val['mc_accuracy']:.4f}")
    moved = torch.linalg.vector_norm(session.full_params_vec() - p0)
    return {**val, "history": history, "grad_size": session.grad_size,
            "bytes_per_round": bpr, "param_delta_norm": float(moved),
            "sketch_decode": session.sketch_decode_resolved,
            "aggregate": session.aggregate_resolved,
            "samples": hooks.samples, "hf_weights": hf_loaded, "real": real,
            "checkpoint": ckpt, "final_step": session.state.step,
            "data_path": session.data_path,
            "pipeline_stats": pipeline_stats or None,
            "logdir": writer.logdir if writer is not None else None,
            "control": (session.controller.snapshot()
                        if session.controller is not None else None)}


if __name__ == "__main__":
    main()

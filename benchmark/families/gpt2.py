"""The program's GPT-2 double-heads model for a configuration file, built
as ``gpt2_train`` builds it: its ``gpt2_config`` (GPT-2 small, or the
tests' ``gpt2_tiny``), the port's own forward and loss
(``models/gpt2.py``, ``models/losses.py``) and its ``build_session``,
over the benchmark's weights."""

from __future__ import annotations

import functools

from commefficient_tpu_torch.models import gpt2 as port_gpt2
from commefficient_tpu_torch.models.losses import gpt2_double_heads_loss
from commefficient_tpu_torch.train import gpt2_train

AUGMENT = None
WIDTHS = ("n_positions", "n_embd", "n_layer", "n_head",
          "layer_norm_epsilon")


def config_fields(cfg: dict, tr: dict) -> dict:
    """The program's Config fields this configuration and traffic set."""
    return {"model": cfg.get("program_model", "gpt2"),
            "dataset_name": "personachat",
            "compute_dtype": cfg["compute_dtype"],
            "lm_coef": cfg["lm_coef"], "mc_coef": cfg["mc_coef"],
            "max_seq_len": tr["max_seq_len"],
            "num_candidates": tr["num_candidates"],
            "max_history": tr["max_history"]}


def session(cfg, config: dict, params):
    """The program's ``FederatedSession`` over ``params``; refuses a
    configuration file whose widths the entry's model does not have."""
    gcfg = gpt2_train.gpt2_config(
        cfg, config["vocab_size"] + config["added_special_tokens"])
    differ = {k: (getattr(gcfg, k), config[k]) for k in WIDTHS
              if getattr(gcfg, k) != config[k]}
    if differ:
        raise ValueError(f"the program's {cfg.model} differs from the "
                         f"configuration file: {differ}")
    loss_fn = gpt2_double_heads_loss(
        functools.partial(port_gpt2.gpt2_apply, cfg=gcfg), cfg.lm_coef,
        cfg.mc_coef, compute_dtype=cfg.compute_dtype)
    return gpt2_train.build_session(cfg, gcfg, params, loss_fn)

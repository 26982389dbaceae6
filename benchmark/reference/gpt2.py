"""GPT-2 with the double heads, plain PyTorch in float32 (Radford et al.
2019, and the LM + multiple-choice heads of the PersonaChat fine-tuning
recipe): token + position + token-type embeddings (the token types are
rows of the token table), pre-LayerNorm blocks of causal self-attention
and a tanh-GELU MLP, a final LayerNorm, an LM head tied to the token
table and a one-output MC head read at each candidate's last token.
The loss is the token-mean next-token cross-entropy over the labelled
positions plus the cross-entropy of the candidate scores.

Every product goes through ``rnd`` (``precision.py``): no rounding for
the reference, fp8 for its control."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

IGNORE = -100


def _mm(rnd, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return rnd.output(torch.matmul(rnd.operand(a), rnd.operand(b)))


def _dense(rnd, p: Dict[str, torch.Tensor], pre: str, x):
    return _mm(rnd, x, p[pre + "/kernel"]) + p[pre + "/bias"]


def _ln(p, pre: str, x, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[pre + "/scale"], p[pre + "/bias"],
                        eps)


def loss(cfg: dict, p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         rnd) -> torch.Tensor:
    """One client's loss; ``p`` maps each leaf's path to its tensor and
    ``batch`` holds ``[B, N, T]`` token arrays (``mc_token_ids [B, N]``,
    ``mc_labels [B]``)."""
    ids = batch["input_ids"].long()
    B, N, T = ids.shape
    ids = ids.reshape(B * N, T)
    types = batch["token_type_ids"].long().reshape(B * N, T)
    t = "params/transformer/"
    wte = p[t + "wte"]
    h = wte[ids] + p[t + "wpe"][:T] + wte[types]
    E, H, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    hd = E // H
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    for i in range(cfg["n_layer"]):
        b = f"{t}h_{i}/"
        qkv = _dense(rnd, p, b + "attn/c_attn", _ln(p, b + "ln_1", h, eps))
        q, k, v = (u.reshape(B * N, T, H, hd).transpose(1, 2)
                   for u in qkv.split(E, dim=-1))
        scores = _mm(rnd, q, k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~causal, float("-inf"))
        att = _mm(rnd, torch.softmax(scores, dim=-1), v)
        att = att.transpose(1, 2).reshape(B * N, T, E)
        h = h + _dense(rnd, p, b + "attn/c_proj", att)
        m = F.gelu(_dense(rnd, p, b + "mlp/c_fc", _ln(p, b + "ln_2", h, eps)),
                   approximate="tanh")
        h = h + _dense(rnd, p, b + "mlp/c_proj", m)
    h = _ln(p, t + "ln_f", h, eps)
    logits = _mm(rnd, h, wte.T).reshape(B, N, T, -1)
    labels = batch["lm_labels"].long()
    lm = F.cross_entropy(logits[..., :-1, :].reshape(-1, logits.shape[-1]),
                         labels[..., 1:].reshape(-1), ignore_index=IGNORE)
    last = batch["mc_token_ids"].long().reshape(-1)
    picked = h[torch.arange(B * N, device=h.device), last]
    mc = _dense(rnd, p, "params/mc_head", picked).reshape(B, N)
    mc_loss = F.cross_entropy(mc, batch["mc_labels"].long())
    return cfg["lm_coef"] * lm + cfg["mc_coef"] * mc_loss

"""Autoregressive GPT-2 decoding with a KV cache (the port of the
reference's ``models/generate.py``).

A prefill pass over the prompt fills the per-layer K/V caches ``[L, B, H,
T_total, hd]``; each new position then attends its one query token over
the cache. The numbers are the reference's: ``manual_layer_norm`` (its
unclamped ``E[x^2] - mean^2`` form), products in ``cfg.dtype``, f32
scores masked to ``finfo(float32).min``, the tanh GELU, and f32 logits.
Greedy (``temperature=0``) or temperature / top-k sampling from a
``torch.Generator`` (its draws are not JAX's; greedy decodes are equal,
pinned by tests/test_torch_gpt2.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from commefficient_tpu_torch.models.gpt2 import (
    F32_MIN,
    GPT2Config,
    attention_probs,
    dense,
    embed,
    manual_layer_norm,
    mlp,
    split_heads,
)


def _qkv(h, blk, cfg):
    """LayerNorm and the packed qkv projection -> per-head q, k, v."""
    x = manual_layer_norm(h, blk["ln_1"], cfg.layer_norm_epsilon)
    qkv = dense(blk["attn"]["c_attn"], x, cfg.dtype)
    return tuple(split_heads(u, cfg.n_head)
                 for u in qkv.split(cfg.n_embd, dim=-1))


def _finish_block(h, blk, cfg, q, k_ctx, v_ctx, mask):
    """Attention of ``q`` over (k_ctx, v_ctx) where ``mask`` [Tq, Tc] is
    True, then the output projection and the MLP, each with its
    residual."""
    dt = cfg.dtype
    scores = torch.matmul(q, k_ctx.transpose(-1, -2)).to(torch.float32)
    probs = attention_probs(scores, mask, q.shape[-1], v_ctx.dtype)
    ctx = torch.matmul(probs, v_ctx).transpose(1, 2).reshape(h.shape)
    h = h + dense(blk["attn"]["c_proj"], ctx, dt)
    x = manual_layer_norm(h, blk["ln_2"], cfg.layer_norm_epsilon)
    return h + mlp(blk, x, dt)


def _lm_logits(t, h_tok, cfg):
    h1 = manual_layer_norm(h_tok, t["ln_f"], cfg.layer_norm_epsilon)
    return (h1 @ t["wte"].to(h1.dtype).T).to(torch.float32)


def _select(logits, temperature: float, top_k: int, generator):
    if temperature <= 0.0:
        return torch.argmax(logits, -1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, F32_MIN, logits)
    return torch.multinomial(torch.softmax(logits, -1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def generate(cfg: GPT2Config, params, input_ids: torch.Tensor,
             max_new_tokens: int, *,
             token_type_ids: Optional[torch.Tensor] = None,
             new_token_type: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, generator: Optional[torch.Generator] = None,
             eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Decode ``max_new_tokens`` continuations of ``input_ids [B, T0]`` ->
    ``[B, T0 + max_new_tokens]`` int64; once a row emits ``eos_token_id``
    its later positions are eos. ``new_token_type`` is the token type
    embedded at generated positions (None: none)."""
    B, T0 = input_ids.shape
    T = T0 + max_new_tokens
    if T > cfg.n_positions:
        raise ValueError(f"T0+max_new={T} exceeds n_positions="
                         f"{cfg.n_positions}")
    t = params["params"]["transformer"]
    dev, dt = input_ids.device, cfg.dtype
    L, H, hd = cfg.n_layer, cfg.n_head, cfg.n_embd // cfg.n_head
    blocks = [t[f"h_{i}"] for i in range(L)]
    cache_k = torch.zeros(L, B, H, T, hd, dtype=dt, device=dev)
    cache_v = torch.zeros_like(cache_k)
    # prefill: a causal pass over the prompt, the caches filled
    h = embed(t, input_ids, torch.arange(T0, device=dev), token_type_ids, dt)
    causal = torch.ones(T0, T0, dtype=torch.bool, device=dev).tril()
    for i, blk in enumerate(blocks):
        q, k, v = _qkv(h, blk, cfg)
        cache_k[i, :, :, :T0] = k
        cache_v[i, :, :, :T0] = v
        h = _finish_block(h, blk, cfg, q, k, v, causal)
    tok = _select(_lm_logits(t, h[:, -1], cfg), temperature, top_k,
                  generator)
    done = (tok == eos_token_id if eos_token_id is not None
            else torch.zeros(B, dtype=torch.bool, device=dev))
    new = [tok]
    tt1 = (None if new_token_type is None else
           torch.full((B, 1), new_token_type, dtype=torch.long, device=dev))
    # each step feeds the token at position pos and emits the next one
    for pos in range(T0, T - 1):
        h = embed(t, tok[:, None], torch.tensor([pos], device=dev), tt1, dt)
        mask = (torch.arange(T, device=dev) <= pos)[None, :]
        for j, blk in enumerate(blocks):
            q1, k1, v1 = _qkv(h, blk, cfg)
            cache_k[j, :, :, pos:pos + 1] = k1
            cache_v[j, :, :, pos:pos + 1] = v1
            h = _finish_block(h, blk, cfg, q1, cache_k[j], cache_v[j], mask)
        tok = _select(_lm_logits(t, h[:, 0], cfg), temperature, top_k,
                      generator)
        if eos_token_id is not None:
            tok = torch.where(done, eos_token_id, tok)
            done = done | (tok == eos_token_id)
        new.append(tok)
    return torch.cat([input_ids.long(), torch.stack(new, 1)], dim=1)

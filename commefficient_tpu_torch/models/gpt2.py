"""GPT-2 with the double heads (LM + multiple choice) — the port of the
reference's ``models/gpt2.py``, functional, over views of the flat
parameter vector (as ``resnet9_apply`` is).

GPT-2 small by default (12 layers, 768 wide, D = 124,444,417 with the
PersonaChat vocabulary): token + position (+ token-type, through the token
table) embeddings, pre-LN blocks of causal self-attention and a tanh-GELU
MLP, a final LayerNorm, an LM head tied to the token table and an MC head
that scores each candidate from the hidden state at its last token.

The numbers follow flax's dtype flow op by op (ROADMAP hazards; each is
held against the live JAX run by tests/test_torch_gpt2.py):

* ``cfg.dtype`` is the modules' compute type (bf16 under ``mixed`` and
  ``bfloat16``, f32 under ``float32``). A Dense casts its input, kernel
  and bias to it, multiplies and adds the bias in it (``nn.Dense``).
* The embeddings are gathered and summed in the params' own type (f32,
  or bf16 when ``compute_dtype=bfloat16`` cast the params), then cast to
  ``cfg.dtype``; the residual stream stays in that type.
* Attention scores come out of a product in ``cfg.dtype`` and are THEN
  cast to f32; the causal mask fills ``finfo(float32).min`` (not -inf);
  the softmax is f32 and its probabilities are cast back.
* The GELU is the tanh form (``nn.gelu(approximate=True)``).
* LayerNorm is flax's: f32 statistics with the fast variance
  ``max(0, E[x^2] - mean^2)``, ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias`` in f32, then cast to ``cfg.dtype``. It is not
  ``F.layer_norm`` (two-pass variance, another rounding order).
  ``manual_layer_norm`` is the reference's own helper for the KV-cache
  decode: unclamped, and ``(x - mean) * rsqrt`` before the scale.
* The LM head multiplies in the hidden state's type and returns f32.

Attention is the plain product (``torch.matmul``), as the reference leaves
it to XLA: no Pallas kernel is on this path, so there is no kernel to port
and no fused attention (whose numerics differ) is used.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16


def gpt2_tiny_config() -> GPT2Config:
    """The tests' config: the same code path at ~0.5M params."""
    return GPT2Config(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
                      n_head=4)


def _dense_shape(n_in: int, n_out: int) -> Dict[str, tuple]:
    return {"bias": (n_out,), "kernel": (n_in, n_out)}


def _ln_shape(e: int) -> Dict[str, tuple]:
    return {"bias": (e,), "scale": (e,)}


def gpt2_shapes(cfg: GPT2Config) -> Dict:
    """Nested dict of leaf shapes, keyed like flax's ``model.init`` (the
    flat vector sorts keys as ``ravel_pytree`` does, so ``h_10`` precedes
    ``h_2``: ``ops/param_utils.tree_leaves``)."""
    E = cfg.n_embd
    tr: Dict = {"wte": (cfg.vocab_size, E), "wpe": (cfg.n_positions, E),
                "ln_f": _ln_shape(E)}
    for i in range(cfg.n_layer):
        tr[f"h_{i}"] = {
            "ln_1": _ln_shape(E), "ln_2": _ln_shape(E),
            "attn": {"c_attn": _dense_shape(E, 3 * E),
                     "c_proj": _dense_shape(E, E)},
            "mlp": {"c_fc": _dense_shape(E, 4 * E),
                    "c_proj": _dense_shape(4 * E, E)},
        }
    return {"params": {"transformer": tr, "mc_head": _dense_shape(E, 1)}}


def init_gpt2(cfg: GPT2Config, seed: int, device="cpu") -> Dict:
    """The port's own initializer, in flax's distributions: normal(0,
    ``initializer_range``) for the embeddings and every kernel, zero
    biases, unit LayerNorm scales, drawn from a ``torch.Generator`` seeded
    with ``seed`` (not JAX's bits: parity tests load the reference's params
    through ``interop``)."""
    g = torch.Generator().manual_seed(seed)

    def make(leaf: str, shape: tuple) -> torch.Tensor:
        if leaf == "scale":
            return torch.ones(shape, device=device)
        if leaf == "bias":
            return torch.zeros(shape, device=device)
        t = torch.randn(shape, generator=g) * cfg.initializer_range
        return t.to(device)

    def walk(node, leaf=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in sorted(node.items())}
        return make(leaf, node)

    return walk(gpt2_shapes(cfg))


def layer_norm(x: torch.Tensor, p, eps: float, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)`` (fast variance, f32 statistics)."""
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * p["scale"]
    return ((x32 - mean) * mul + p["bias"]).to(dtype)


def manual_layer_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """The reference's ``manual_layer_norm``: f32 statistics with
    ``E[x^2] - mean^2`` (unclamped), ``(x - mean) * rsqrt(var + eps)``,
    then ``* scale + bias``, in ``x``'s type. The KV-cache decode uses it,
    as the reference's does."""
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def dense(p, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``, the product and the bias add in it."""
    return x.to(dtype) @ p["kernel"].to(dtype) + p["bias"].to(dtype)


F32_MIN = torch.finfo(torch.float32).min


def attention_probs(scores: torch.Tensor, mask: torch.Tensor, hd: int,
                    dtype) -> torch.Tensor:
    """f32 scores (from a product in the compute type) -> probabilities
    in ``dtype``: scaled by 1/sqrt(hd), masked to ``finfo(f32).min``
    where ``mask`` is False, softmax in f32."""
    scores = torch.where(mask, scores / math.sqrt(hd), F32_MIN)
    return torch.softmax(scores, dim=-1).to(dtype)


def dense_causal_attention(q, k, v) -> torch.Tensor:
    """``[B, H, T, hd]`` q/k/v -> ``[B, H, T, hd]``: the reference's
    ``dense_causal_attention``."""
    hd = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
    t = scores.shape[-1]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.matmul(attention_probs(scores, mask, hd, v.dtype), v)


def split_heads(u: torch.Tensor, n_head: int) -> torch.Tensor:
    B, T, E = u.shape
    return u.reshape(B, T, n_head, E // n_head).transpose(1, 2)


def mlp(blk, x: torch.Tensor, dtype) -> torch.Tensor:
    h = F.gelu(dense(blk["mlp"]["c_fc"], x, dtype), approximate="tanh")
    return dense(blk["mlp"]["c_proj"], h, dtype)


def _block(blk, x: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    dt, eps, H = cfg.dtype, cfg.layer_norm_epsilon, cfg.n_head
    B, T, E = x.shape
    qkv = dense(blk["attn"]["c_attn"], layer_norm(x, blk["ln_1"], eps, dt),
                dt)
    q, k, v = (split_heads(u, H) for u in qkv.split(E, dim=-1))
    out = dense_causal_attention(q, k, v).transpose(1, 2).reshape(B, T, E)
    x = x + dense(blk["attn"]["c_proj"], out, dt)
    return x + mlp(blk, layer_norm(x, blk["ln_2"], eps, dt), dt)


def embed(t, ids: torch.Tensor, positions: torch.Tensor,
          token_type_ids: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Token + position (+ token-type rows of the token table) in the
    params' type, then cast to the compute type."""
    h = t["wte"][ids.long()] + t["wpe"][positions]
    if token_type_ids is not None:
        h = h + t["wte"][token_type_ids.long()]
    return h.to(dtype)


def gpt2_backbone(params, input_ids: torch.Tensor,
                  token_type_ids: Optional[torch.Tensor],
                  cfg: GPT2Config) -> torch.Tensor:
    """``[B, T]`` ids -> ``[B, T, E]`` hidden states after ``ln_f``."""
    t = params["params"]["transformer"]
    positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
    h = embed(t, input_ids, positions, token_type_ids, cfg.dtype)
    for i in range(cfg.n_layer):
        h = _block(t[f"h_{i}"], h, cfg)
    return layer_norm(h, t["ln_f"], cfg.layer_norm_epsilon, cfg.dtype)


def gpt2_apply(params, input_ids: torch.Tensor,
               token_type_ids: Optional[torch.Tensor] = None,
               mc_token_ids: Optional[torch.Tensor] = None, *,
               cfg: GPT2Config
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``input_ids [..., T]`` (``[B, N, T]``: N candidates a dialog) ->
    ``(lm_logits [..., T, V] f32, mc_logits [...] f32 or None)``. At
    full width one client's f32 logits are 411,746,304 B (``[4, 2, 256,
    50262]``); the round's per-client loop frees each client's graph
    before the next."""
    shape = input_ids.shape

    def flat(u):
        return None if u is None else u.reshape(-1, shape[-1])

    h = gpt2_backbone(params, flat(input_ids), flat(token_type_ids), cfg)
    wte = params["params"]["transformer"]["wte"]
    lm_logits = (h @ wte.to(h.dtype).T).to(torch.float32)
    lm_logits = lm_logits.reshape(*shape, cfg.vocab_size)
    if mc_token_ids is None:
        return lm_logits, None
    flat_mc = mc_token_ids.reshape(-1).long()
    picked = h[torch.arange(flat_mc.shape[0], device=h.device), flat_mc]
    score = dense(params["params"]["mc_head"], picked, cfg.dtype)
    return lm_logits, score.to(torch.float32).reshape(shape[:-1])

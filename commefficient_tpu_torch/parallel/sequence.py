"""The sequence-parallel GPT-2 forward: ring attention over the grid's
seq group (the reference's ``parallel/sequence.py``).

Each rank of the seq group runs the dense GPT-2 backbone
(``models.gpt2_backbone``) on its block of the tokens: the embeddings,
LayerNorms and MLPs are position-wise, attention is ring attention
(``parallel.ring_attention``) and the position embeddings start at the
block's global offset. Activation memory a rank is O(T / seq). This is
the standalone long-context forward; the federated round's
sequence-parallel loss is ``parallel/tensor.py``'s ``build_tp_flat_loss``
(``--seq_axis``).
"""

from __future__ import annotations

from functools import partial

import torch

from commefficient_tpu_torch.models.gpt2 import (
    GPT2Config,
    dense,
    gpt2_backbone,
)
from commefficient_tpu_torch.parallel.ring_attention import (
    gather_tokens,
    ring_attention,
)


def sp_gpt2_apply(seq, cfg: GPT2Config, params, input_ids,
                  token_type_ids=None, mc_token_ids=None):
    """The sequence-parallel ``gpt2_apply`` (forward only: the hidden
    states' gather has no gradient). ``input_ids``/``token_type_ids``
    ``[B, N, T]`` (T divisible by the size of ``seq``, the seq group) and
    ``mc_token_ids [B, N]`` are the whole batch on every rank; each rank
    computes its token block, and the blocks' hidden states are gathered
    before the heads. Returns ``(lm_logits [B, N, T, V], mc_logits [B, N]
    | None)``, whole on every rank."""
    shape = input_ids.shape
    T = shape[-1]
    if T % seq.size:
        raise ValueError(f"T={T} must divide by seq axis {seq.size}")
    t_loc = T // seq.size
    lo = seq.rank * t_loc

    def block(u):
        return None if u is None else u.reshape(-1, T)[:, lo:lo + t_loc]

    positions = lo + torch.arange(t_loc, device=input_ids.device)
    h = gpt2_backbone(params, block(input_ids), block(token_type_ids), cfg,
                      attn_fn=partial(ring_attention, group=seq),
                      positions=positions)
    h = gather_tokens(seq, h, dim=1)  # [R, T, E]
    wte = params["params"]["transformer"]["wte"]
    lm_logits = (h @ wte.to(h.dtype).T).to(torch.float32)
    lm_logits = lm_logits.reshape(*shape, cfg.vocab_size)
    if mc_token_ids is None:
        return lm_logits, None
    flat_mc = mc_token_ids.reshape(-1).long()
    picked = h[torch.arange(flat_mc.shape[0], device=h.device), flat_mc]
    score = dense(params["params"]["mc_head"], picked, cfg.dtype)
    return lm_logits, score.to(torch.float32).reshape(shape[:-1])

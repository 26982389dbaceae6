"""Loss conventions (the reference's ``models/losses.py``).

``loss_fn(params, batch) -> (loss, metrics)``; labels equal to
``IGNORE_INDEX`` (padded eval rows, the GPT-2 prompt positions) count for
nothing. Cross-entropy is float32 whatever the model's compute type.

The three compute types (``Config.compute_dtype``): ``mixed`` and
``float32`` differ only in the model's own compute type (``model_dtype``:
bf16 products over f32 params, or f32 throughout); ``bfloat16`` also
casts the params (and a CV batch's images) to bf16 at the loss boundary
(``_cast_floats``), which reaches what the module type cannot: GPT-2's
embedding gather and sum, its residual stream and its tied head. For
ResNet-9, which casts its stream at entry, it changes nothing. The master
params, the gradients (the cast's backward returns f32) and everything
after stay f32.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def model_dtype(compute_dtype: str) -> torch.dtype:
    """Model compute type for a ``Config.compute_dtype``: bf16 for
    ``mixed`` and ``bfloat16``, f32 for ``float32``."""
    return torch.float32 if compute_dtype == "float32" else torch.bfloat16


def _resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """The loss-boundary cast of a compute type: bf16 for ``bfloat16``,
    none for ``mixed`` and ``float32`` (they differ at the model)."""
    if compute_dtype in (None, "mixed", "float32"):
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(
        f"compute_dtype must be mixed|float32|bfloat16, got {compute_dtype!r}")


def _cast_floats(tree, dtype: torch.dtype):
    """The float leaves of a nested dict of tensors cast to ``dtype`` (a
    differentiable cast: the gradient flows back to the f32 leaves)."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def softmax_cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of NLL over non-ignored positions, #non-ignored positions)."""
    mask = (labels != IGNORE_INDEX).to(torch.float32)
    safe = torch.where(labels == IGNORE_INDEX, torch.zeros_like(labels),
                       labels).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean NLL over the non-ignored positions (``CrossEntropyLoss(
    ignore_index=-100)``)."""
    s, n = softmax_cross_entropy_sum(logits, labels)
    return s / torch.clamp(n, min=1.0)


def classification_loss(apply_fn, prep=None, compute_dtype=None):
    """Build the CV ``loss_fn`` for ``batch = {"x": [B,...], "y": [B]}``.
    ``prep`` maps raw images on the batch's device (uint8 -> normalized);
    ``compute_dtype="bfloat16"`` casts params and images at the boundary."""
    cd = _resolve_compute_dtype(compute_dtype)

    def loss_fn(params, batch):
        x = batch["x"] if prep is None else prep(batch["x"])
        if cd is not None:
            params = _cast_floats(params, cd)
            x = x.to(cd)
        y = batch["y"]
        logits = apply_fn(params, x)
        loss = softmax_cross_entropy(logits, y)
        mask = y != IGNORE_INDEX
        correct = torch.sum((torch.argmax(logits, -1) == y) & mask).to(
            torch.float32)
        return loss, {"correct": correct, "count": torch.sum(mask).to(
            torch.float32)}

    return loss_fn


def gpt2_double_heads_loss(apply_fn, lm_coef: float = 1.0,
                           mc_coef: float = 1.0, compute_dtype=None):
    """Build the GPT-2 twin loss ``lm_coef * CE_lm + mc_coef * CE_mc`` for
    ``batch = {"input_ids", "token_type_ids", "lm_labels": [B, N, T],
    "mc_token_ids": [B, N], "mc_labels": [B]}``: the LM loss over the
    next-token shift (logits at t predict the label at t + 1), token
    weighted; metrics the two losses, the MC ``correct`` / ``count`` and
    the token-weighted pair ``lm_loss_sum`` / ``token_count`` (summed
    over eval batches for an exact nll)."""
    cd = _resolve_compute_dtype(compute_dtype)

    def loss_fn(params, batch):
        if cd is not None:
            params = _cast_floats(params, cd)
        lm_logits, mc_logits = apply_fn(
            params, batch["input_ids"],
            token_type_ids=batch.get("token_type_ids"),
            mc_token_ids=batch["mc_token_ids"])
        lm_sum, tok_count = softmax_cross_entropy_sum(
            lm_logits[..., :-1, :], batch["lm_labels"][..., 1:])
        lm_loss = lm_sum / torch.clamp(tok_count, min=1.0)
        mc_labels = batch["mc_labels"]
        mc_loss = softmax_cross_entropy(mc_logits, mc_labels)
        loss = lm_coef * lm_loss + mc_coef * mc_loss
        mc_mask = mc_labels != IGNORE_INDEX
        mc_correct = torch.sum(
            (torch.argmax(mc_logits, -1) == mc_labels) & mc_mask).to(
            torch.float32)
        return loss, {
            "lm_loss": lm_loss, "mc_loss": mc_loss, "correct": mc_correct,
            "count": torch.sum(mc_mask).to(torch.float32),
            "lm_loss_sum": lm_sum, "token_count": tok_count,
        }

    return loss_fn

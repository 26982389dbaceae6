"""Loss conventions (the reference's ``models/losses.py``, CV part).

``loss_fn(params, batch) -> (mean CE, {"correct", "count"})``; labels equal
to ``IGNORE_INDEX`` (padded eval rows) count for nothing. Cross-entropy is
float32 whatever the model's compute type.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def model_dtype(compute_dtype: str) -> torch.dtype:
    """Model compute type for a ``Config.compute_dtype``: ``mixed`` runs the
    model in bfloat16 (master params, gradients and CE stay f32)."""
    return torch.float32 if compute_dtype == "float32" else torch.bfloat16


def softmax_cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of NLL over non-ignored positions, #non-ignored positions)."""
    mask = (labels != IGNORE_INDEX).to(torch.float32)
    safe = torch.where(labels == IGNORE_INDEX, torch.zeros_like(labels),
                       labels).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def classification_loss(apply_fn, prep=None):
    """Build the CV ``loss_fn`` for ``batch = {"x": [B,...], "y": [B]}``.
    ``prep`` maps raw images on the batch's device (uint8 -> normalized)."""

    def loss_fn(params, batch):
        x = batch["x"] if prep is None else prep(batch["x"])
        y = batch["y"]
        logits = apply_fn(params, x)
        s, n = softmax_cross_entropy_sum(logits, y)
        loss = s / torch.clamp(n, min=1.0)
        mask = y != IGNORE_INDEX
        correct = torch.sum((torch.argmax(logits, -1) == y) & mask).to(
            torch.float32)
        return loss, {"correct": correct, "count": torch.sum(mask).to(
            torch.float32)}

    return loss_fn

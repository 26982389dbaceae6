"""Learning-rate schedule (the reference's ``utils/schedule.py``, host path).

cifar10-fast piecewise-linear: 0 at epoch 0, ``lr_scale`` at ``pivot_epoch``,
0 again at ``num_epochs``. The port evaluates it on the host once per round,
so only the reference's python-float branch is carried over.
"""

from __future__ import annotations


def piecewise_linear_lr(step: int, *, steps_per_epoch: int,
                        pivot_epoch: float, num_epochs: float,
                        lr_scale: float) -> float:
    """LR at optimizer step ``step`` (host int)."""
    epoch = (step + 1) / steps_per_epoch
    up = epoch / max(pivot_epoch, 1e-8)
    down = (num_epochs - epoch) / max(num_epochs - pivot_epoch, 1e-8)
    return lr_scale * min(max(min(up, down), 0.0), 1.0)

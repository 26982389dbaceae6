"""Models and losses of the port."""

from commefficient_tpu_torch.models.losses import (
    IGNORE_INDEX,
    classification_loss,
    model_dtype,
)
from commefficient_tpu_torch.models.resnet9 import (
    init_resnet9,
    resnet9_apply,
    resnet9_shapes,
)

__all__ = ["IGNORE_INDEX", "classification_loss", "init_resnet9",
           "model_dtype", "resnet9_apply", "resnet9_shapes"]

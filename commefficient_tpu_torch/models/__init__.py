"""Models and losses of the port."""

from commefficient_tpu_torch.models.gpt2 import (
    GPT2Config,
    gpt2_apply,
    gpt2_shapes,
    gpt2_tiny_config,
    init_gpt2,
)
from commefficient_tpu_torch.models.losses import (
    IGNORE_INDEX,
    classification_loss,
    gpt2_double_heads_loss,
    model_dtype,
)
from commefficient_tpu_torch.models.resnet9 import (
    init_resnet9,
    resnet9_apply,
    resnet9_shapes,
)

__all__ = ["GPT2Config", "IGNORE_INDEX", "classification_loss",
           "gpt2_apply", "gpt2_double_heads_loss", "gpt2_shapes",
           "gpt2_tiny_config", "init_gpt2", "init_resnet9", "model_dtype",
           "resnet9_apply", "resnet9_shapes"]

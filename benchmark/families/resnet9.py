"""The program's ResNet-9 for a configuration file, built as ``cv_train``
builds it: the port's own forward and loss (``models/resnet9.py``,
``models/losses.py``), its uint8 normaliser and its augmentation (crop,
flip, cutout) on the device-resident training set."""

from __future__ import annotations

import functools

from commefficient_tpu_torch.data.cifar import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    augment_batch,
    normalizer,
)
from commefficient_tpu_torch.models.losses import (
    classification_loss,
    model_dtype,
)
from commefficient_tpu_torch.models.resnet9 import resnet9_apply
from commefficient_tpu_torch.parallel import FederatedSession

AUGMENT = augment_batch


def config_fields(cfg: dict, tr: dict) -> dict:
    return {"model": "resnet9", "dataset_name": "cifar10",
            "compute_dtype": cfg["compute_dtype"],
            "num_classes": cfg["num_classes"]}


def session(cfg, config: dict, params):
    apply = functools.partial(resnet9_apply,
                              dtype=model_dtype(cfg.compute_dtype))
    loss_fn = classification_loss(
        apply, prep=normalizer(CIFAR10_MEAN, CIFAR10_STD),
        compute_dtype=cfg.compute_dtype)
    return FederatedSession(cfg, params, loss_fn)

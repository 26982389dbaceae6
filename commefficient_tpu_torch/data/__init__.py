"""Federated data pipeline of the port: host-side numpy, own copies of the
reference's dataset, sampler, CIFAR-10/100, FEMNIST, ImageNet and
PersonaChat pieces (same draws per seed), and the augments' device forms
for the device-resident training set."""

from commefficient_tpu_torch.data.cifar import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    CifarAugment,
    augment_batch,
    device_augment,
    load_fed_cifar10,
    load_fed_cifar100,
    normalizer,
)
from commefficient_tpu_torch.data.emnist import load_fed_emnist
from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.imagenet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageNetAugment,
    RRCPlan,
    load_fed_imagenet,
)
from commefficient_tpu_torch.data.personachat import load_fed_personachat
from commefficient_tpu_torch.data.sampler import FedSampler

__all__ = ["CIFAR10_MEAN", "CIFAR10_STD", "CifarAugment", "FedDataset",
           "FedSampler", "IMAGENET_MEAN", "IMAGENET_STD", "ImageNetAugment",
           "RRCPlan", "augment_batch", "device_augment", "load_fed_cifar10",
           "load_fed_cifar100", "load_fed_emnist", "load_fed_imagenet",
           "load_fed_personachat", "normalizer"]

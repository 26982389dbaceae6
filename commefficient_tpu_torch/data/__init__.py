"""Federated data pipeline of the port: host-side numpy, own copies of the
reference's dataset, sampler, CIFAR-10 and PersonaChat pieces (same
draws per seed)."""

from commefficient_tpu_torch.data.cifar import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    CifarAugment,
    augment_batch,
    load_fed_cifar10,
    normalizer,
)
from commefficient_tpu_torch.data.fed_dataset import FedDataset
from commefficient_tpu_torch.data.personachat import load_fed_personachat
from commefficient_tpu_torch.data.sampler import FedSampler

__all__ = ["CIFAR10_MEAN", "CIFAR10_STD", "CifarAugment", "FedDataset",
           "FedSampler", "augment_batch", "load_fed_cifar10",
           "load_fed_personachat", "normalizer"]

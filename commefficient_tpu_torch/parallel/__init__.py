"""The round engine and session of the port (one device)."""

from commefficient_tpu_torch.parallel.api import (
    FederatedSession,
    FedModel,
    FedOptimizer,
    make_fed_pair,
)
from commefficient_tpu_torch.parallel.round import (
    FedState,
    mask_classification,
    mask_gpt2,
)

__all__ = ["FedModel", "FedOptimizer", "FedState", "FederatedSession",
           "make_fed_pair", "mask_classification", "mask_gpt2"]

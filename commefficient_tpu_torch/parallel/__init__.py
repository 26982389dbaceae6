"""The round engine and session of the port (one device)."""

from commefficient_tpu_torch.parallel.api import (
    FederatedSession,
    FedModel,
    FedOptimizer,
    make_fed_pair,
)
from commefficient_tpu_torch.parallel.round import FedState

__all__ = ["FedModel", "FedOptimizer", "FedState", "FederatedSession",
           "make_fed_pair"]

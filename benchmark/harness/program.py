"""The system under test, built for a cell the way ``cv_train`` and
``gpt2_train`` build it: the program's ``Config`` from the configuration
and traffic files, its session (``benchmark/families/``), the
benchmark's weights and training set, its ``FedDataset`` and
``FedSampler``, and the ``FederatedSession`` with the training set
attached on the device. The rounds then come from the runner's own round
source, ``runner.round_source``."""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.yardstick import traffic, weights
from benchmark.yardstick.layout import leaves, offsets

STOP = 1 << 40  # the round source runs until the benchmark stops it


@dataclass
class Program:
    cfg: Any  # the program's Config
    session: Any
    sampler: Any
    data: Dict[str, np.ndarray]
    client_indices: List[np.ndarray]
    lr: float

    def rounds(self, start: int = 0, stop: int = STOP):
        """The runner's round source over rounds ``[start, stop)``:
        yields ``(step, lr, metrics, wait_ms, t_dispatch)`` a round."""
        from commefficient_tpu_torch.train.runner import round_source

        return round_source(self.cfg, self.session, self.sampler,
                            lambda s: self.lr, start, stop)


def nested_views(vec: torch.Tensor, cfg: dict) -> dict:
    """The flat vector as the nested dict of views the program's session
    takes (its ravel order is the layout's)."""
    layout = leaves(cfg)
    tree: dict = {}
    for (path, shape), (_, o, n) in zip(layout, offsets(layout)):
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = vec[o:o + n].view(shape)
    return tree


def build(config: dict, tr: dict, seed: int, device: str) -> Program:
    """The program for a cell: its weights and training set from ``seed``;
    its own seed (the sketch's hashes, the sampler's draws) the traffic
    file's ``program_seed``, so every run's rounds do the same work."""
    from commefficient_tpu_torch.data import FedSampler
    from commefficient_tpu_torch.data.fed_dataset import FedDataset
    from commefficient_tpu_torch.utils.config import Config

    family = importlib.import_module(f"benchmark.families.{config['family']}")
    opt, rnd = tr["optimizer"], tr["round"]
    pseed = tr["program_seed"]
    cfg = Config(**family.config_fields(config, tr["data"]), **opt, **rnd,
                 num_clients=tr["data"]["num_clients"], seed=pseed,
                 device=device, num_devices=1)
    vec = weights.initial_params(config, seed, device)
    data, client_indices = traffic.make(config, tr["data"], seed, device)
    session = family.session(cfg, config, nested_views(vec, config))
    del vec
    train = FedDataset(data, len(client_indices),
                       client_indices=client_indices, seed=pseed)
    sampler = FedSampler(train, num_workers=cfg.num_workers,
                         local_batch_size=cfg.sampler_batch_size,
                         seed=pseed, augment=family.AUGMENT)
    if not session.maybe_attach_data(train, sampler, family.AUGMENT):
        raise RuntimeError("the training set was not attached on the device"
                           " (device_data_max_mb or the sampler's gate)")
    return Program(cfg, session, sampler, data, client_indices, tr["lr"])

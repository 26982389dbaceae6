"""Federated environment simulator — the port's own copy of the
reference's ``fedsim/`` (numpy only, so both packages draw the same masks
from the same seeds).

* ``availability``: seeded models (``always``, ``bernoulli``, ``sine``,
  ``cohort``, ``poisson``) emitting a round's ``[num_workers]``
  participation mask from ``(seed, round_idx)`` on a stream distinct from
  the sampler's;
* ``faults``: the chaos plan (``--chaos "dropout@0.3:rounds=50-100,
  straggler@0.1,nan_client@120"``) composed on top: extra dropout,
  deadline-missing stragglers, and a non-finite payload from a live
  client;
* ``env``: ``FedEnvironment`` composes the two into one ``RoundEnv`` per
  round (live mask, corruption mask, live count, ``fedsim/*`` scalars).

The round (``parallel/round.py``) applies the masks: corruption first,
then the live mask by ``torch.where`` (a zero mask blocks even a
corrupted NaN), before the linear ``device_encode``; the server
renormalizes by the live count, and a round where every client drops
freezes the params and the server state. A masked round with live cohort
S equals the round over exactly S.

The reference's elastic-fleet kinds (``resize``, ``leave``, ``join``,
``shrink``) and ``preempt`` are parsed here and refused by ``Config``
(ROADMAP A11).
"""

from commefficient_tpu_torch.fedsim.availability import (
    available_models,
    round_rng,
    sample_availability,
)
from commefficient_tpu_torch.fedsim.env import (
    FedEnvironment,
    RoundEnv,
    build_environment,
)
from commefficient_tpu_torch.fedsim.faults import (
    CHAOS_KINDS,
    PORTED_KINDS,
    ChaosEvent,
    apply_chaos,
    parse_chaos,
    validate_chaos_rounds,
)

__all__ = ["CHAOS_KINDS", "PORTED_KINDS", "ChaosEvent", "FedEnvironment",
           "RoundEnv", "apply_chaos", "available_models", "build_environment",
           "parse_chaos", "round_rng", "sample_availability",
           "validate_chaos_rounds"]

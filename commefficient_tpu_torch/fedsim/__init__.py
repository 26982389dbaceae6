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

``preempt@R`` requests a preemption-safe shutdown at round R through the
round's ``fedsim/preempt`` scalar (``resilience/guard.py``); a round
re-executed after a rollback realizes its environment with ``replay=True``,
which suppresses the ``nan_client`` injection and leaves every other draw
as it was. The elastic fleet's kinds (``resize``, ``leave``, ``join``,
``shrink``) set each round's realized width (``faults.fleet_width_at``):
the environment's masks have that many slots, its stats carry the
``fleet/*`` scalars, and the session dispatches the round closure it built
for that width; a ``shrink`` window's first round raises
``FleetShrinkError`` for resilience/ to heal.
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
    fleet_shrink_at,
    fleet_transitions,
    fleet_width_at,
    fleet_widths,
    has_fleet,
    has_preempt,
    parse_chaos,
    preempt_requested,
    validate_chaos_rounds,
)

__all__ = ["CHAOS_KINDS", "PORTED_KINDS", "ChaosEvent", "FedEnvironment",
           "RoundEnv", "apply_chaos", "available_models", "build_environment",
           "fleet_shrink_at", "fleet_transitions", "fleet_width_at",
           "fleet_widths", "has_fleet", "has_preempt", "parse_chaos",
           "preempt_requested", "round_rng", "sample_availability",
           "validate_chaos_rounds"]

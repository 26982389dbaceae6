"""Self-healing training: a divergence becomes a bounded recovery, a
preemption a resumable exit (the port's copy of the reference's
``resilience/``).

  * ``vault``  — ``RollbackVault``: drain-certified snapshots of the whole
    federated state in host memory (copies of every ``FedState`` leaf in
    the checkpoint's layout, the controller's blob, the ledger's
    counters) every ``--snapshot_every`` rounds; the drain before each
    snapshot IS the divergence check, so every snapshot predates the
    divergence.
  * ``policy`` — ``--recover_policy``: ``retry`` replays bit for bit
    (fedsim suppresses the ``nan_client`` injection on a re-executed
    round), ``demote`` floors the control/ ladder one rung cheaper through
    the prewarmed switch (no kernel plan built), ``skip_clients``
    blacklists the bad round's suspects from every later round's
    participation mask.
  * ``guard``  — ``PreemptGuard``: SIGTERM/SIGINT riders (and the seeded
    ``preempt@R`` chaos twin) read once a round; a request drains,
    force-saves a checkpoint and exits with ``EXIT_PREEMPTED`` (75).

``manager.RecoveryManager`` / ``ResilienceRider`` wire them into
``train/runner.py`` once. Exhausted recoveries (``--max_recoveries``)
re-raise the ORIGINAL ``DivergenceError`` with the history attached; every
recovery shows in the ``resilience/*`` scalars and in the flight
recorder's ``recovery_history`` block. ``--recover_policy none`` with no
preemption source builds nothing and installs no signal handler.
"""

from commefficient_tpu_torch.resilience.guard import (
    EXIT_PREEMPTED,
    PreemptGuard,
    PreemptShutdown,
)
from commefficient_tpu_torch.resilience.manager import (
    RecoveryManager,
    ResilienceRider,
    build_resilience,
)
from commefficient_tpu_torch.resilience.policy import (
    POLICIES,
    RecoveryUnavailable,
    available_recover_policies,
    get_recovery_policy,
)
from commefficient_tpu_torch.resilience.vault import RollbackVault

__all__ = [
    "EXIT_PREEMPTED",
    "POLICIES",
    "PreemptGuard",
    "PreemptShutdown",
    "RecoveryManager",
    "RecoveryUnavailable",
    "ResilienceRider",
    "RollbackVault",
    "available_recover_policies",
    "build_resilience",
    "get_recovery_policy",
]

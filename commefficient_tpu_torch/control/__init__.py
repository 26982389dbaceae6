"""The adaptive communication-budget control plane (the port's copy of the
reference's ``control/``).

FetchSGD (arXiv:2007.07682) fixes its compression operating point (k,
sketch columns, powersgd rank) for a run, but the error-feedback analysis
it leans on (arXiv:1903.04488, sharpened by arXiv:2305.15264) says the
useful compression level varies over training. The round already measures
the signals (``diag/ef_residual_norm``, the level-2 fidelity, fedsim
participation, the ledger's bytes); this package closes the loop:

  * ``ladder``     — an ordered rung set, each rung a validated delta of
                     compression parameters over the base Config
                     (``--ladder "k=60000,30000,10000"``). Every rung's
                     CountSketch spec, compressor and round closure are
                     resolved at session build, so a switch is a table
                     lookup plus the state's migration.
  * ``policy``     — host-side rung selection: ``fixed`` (a round-range
                     schedule), ``budget_pacing`` (spend ``--budget_mb``
                     evenly over the remaining rounds, stopping with
                     ``BudgetExhaustedError`` when even the cheapest rung
                     would overshoot), ``ef_feedback`` (closed loop on the
                     EF residual's slope and the fidelity, with
                     hysteresis), ``staleness_aware`` (asyncfed only: the
                     ``async/*`` staleness walks the ladder and the buffer
                     backlog retunes the engine's (K, C)).
  * ``controller`` — the loop: reads the drained telemetry, picks the next
                     round's rung, migrates the compressor's state across
                     rungs (``Compressor.migrate_state``: a ``num_cols``
                     switch decodes each sketch table through K2 and
                     re-sketches it through K1 at the new geometry), puts
                     ``control/*`` scalars on the round's metrics, accounts
                     bytes with the CommLedger's arithmetic, and
                     checkpoints its state so a resume reproduces the rung
                     sequence bit for bit.

``control_policy='none'`` (the default) builds NOTHING: the session has
one rung over the config, no controller exists, and the round runs what
it ran before, launch for launch. ``parallel/api.py`` and the train loop
import this package; ``utils/config.py`` imports ``ladder`` and ``policy``
lazily for its flag checks. Under the elastic fleet every rung holds a
round closure per realized width, and the session's dispatch composes the
active rung with the round's width (``FederatedSession._select_programs``),
so a switch inside a resize window runs the new rung at that width.
"""

from commefficient_tpu_torch.control.controller import (
    BudgetController,
    build_controller,
    controller_header,
)
from commefficient_tpu_torch.control.ladder import (
    LADDER_FIELDS,
    ladder_configs,
    parse_ladder,
    validate_rung_costs,
)
from commefficient_tpu_torch.control.policy import (
    CONTROL_POLICIES,
    BudgetExhaustedError,
    ControlPolicy,
    get_policy,
    initial_rung_index,
    parse_schedule,
)

__all__ = [
    "BudgetController",
    "BudgetExhaustedError",
    "CONTROL_POLICIES",
    "ControlPolicy",
    "LADDER_FIELDS",
    "build_controller",
    "controller_header",
    "get_policy",
    "initial_rung_index",
    "ladder_configs",
    "parse_ladder",
    "parse_schedule",
    "validate_rung_costs",
]

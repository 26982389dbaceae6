"""The compression ladder — the ordered rung set a controller switches
between (the port's copy of the reference's ``control/ladder.py``).

Ladder grammar (the ``--ladder`` flag, validated at construction as
fedsim's chaos strings are):

    field=v1,v2,...[;field=w1,w2,...]

  * ``field`` is one of the rung-tunable compression parameters
    (``LADDER_FIELDS``): ``k``, ``num_cols``, ``powersgd_rank``. Every
    other Config field is shared by all rungs.
  * Each field lists ONE value per rung; several fields (``;``-separated)
    must list the same number of values: rung i takes the i-th value of
    every listed field.
  * Rungs are ordered most expensive first: rung 0 is the highest-
    fidelity, highest-byte setting and no later rung costs more (checked
    against the realized ``bytes_per_round`` at session build, where the
    compressor geometry is known, e.g. the sketch table's realized
    ``r * c_actual``).

``--ladder "k=60000,30000,10000"`` is a three-rung ladder that varies only
the extraction sparsity; ``--ladder "k=50000,25000;num_cols=500000,
250000"`` shrinks the sketch table along with k.

Each rung resolves to a full ``Config`` by ``base.replace(**overrides)``,
so an invalid rung (``powersgd_rank=0``) fails with the Config's own
error, named by rung, before anything is built. Host-side only; the
config is duck-typed (``utils.config`` imports this module lazily for its
flag checks).
"""

from __future__ import annotations

from typing import Tuple

# Config fields a rung may override: each changes only the compression
# OPERATING POINT (payload size, extraction sparsity), never the
# federation's shape or the optimization, which is what makes a mid-run
# switch meaningful rather than another experiment
LADDER_FIELDS = ("k", "num_cols", "powersgd_rank")

_GRAMMAR = (
    '";"-separated "field=v1,v2,..." lists with field in '
    f"{LADDER_FIELDS} and one value per rung (all fields the same "
    'length), e.g. "k=60000,30000,10000" or '
    '"k=50000,25000;num_cols=500000,250000"'
)


def _fail(spec: str, why: str) -> ValueError:
    return ValueError(f"bad ladder {spec!r}: {why}. Grammar: {_GRAMMAR}")


def parse_ladder(spec: str) -> Tuple[dict, ...]:
    """A ladder string -> one override dict per rung; '' -> (). Raises
    ValueError (with the grammar) on any syntax problem."""
    if not spec or not spec.strip():
        return ()
    fields = {}
    for raw in spec.split(";"):
        part = raw.strip()
        if "=" not in part:
            raise _fail(spec, f"segment {part!r} lacks '=values'")
        name, _, vals_s = part.partition("=")
        name = name.strip()
        if name not in LADDER_FIELDS:
            raise _fail(spec, f"unknown ladder field {name!r}")
        if name in fields:
            raise _fail(spec, f"field {name!r} listed twice")
        vals = []
        for v in vals_s.split(","):
            v = v.strip()
            try:
                vals.append(int(v))
            except ValueError:
                raise _fail(spec, f"{name}={v!r} is not an integer") from None
        if not vals:
            raise _fail(spec, f"field {name!r} lists no values")
        if any(v < 1 for v in vals):
            raise _fail(spec, f"{name} values must be >= 1, got {vals}")
        fields[name] = vals
    lengths = {len(v) for v in fields.values()}
    if len(lengths) != 1:
        raise _fail(
            spec,
            "every field must list one value per rung — got lengths "
            + ", ".join(f"{k}:{len(v)}" for k, v in sorted(fields.items())))
    n = lengths.pop()
    return tuple({name: vals[i] for name, vals in fields.items()}
                 for i in range(n))


def ladder_configs(cfg) -> tuple:
    """The per-rung Config tuple of ``cfg``: one ``cfg.replace(**rung)``
    per parsed rung, or ``(cfg,)`` for an empty ladder (a controller over
    one implicit rung: a pure budget cap). Each replace re-runs the
    Config's validation, so a combination the base config would refuse
    fails HERE with the rung named."""
    rungs = parse_ladder(cfg.ladder)
    if not rungs:
        return (cfg,)
    out = []
    for i, ov in enumerate(rungs):
        try:
            out.append(cfg.replace(**ov))
        except ValueError as e:
            raise ValueError(
                f"ladder rung {i} ({ov}) produces an invalid config: {e}"
            ) from e
    return tuple(out)


def validate_rung_costs(bytes_per_rung) -> None:
    """The ladder's cost order: per-round total bytes NON-INCREASING with
    the rung index (rung 0 the most expensive). The policies lean on it:
    ``ef_feedback`` steps to index - 1 to spend more and index + 1 to
    save, and ``budget_pacing`` scans from 0 for the most expensive rung
    that fits. Ties are legal: a sketch ``k`` ladder moves the extraction
    fidelity without touching the table's bytes (the uplink IS the
    table), so such rungs still order by fidelity for the feedback loop
    and are indistinguishable to pacing. ``bytes_per_rung`` holds a
    ``bytes_per_round`` dict per rung, in rung order."""
    totals = [int(b["upload_bytes"]) + int(b["download_bytes"])
              for b in bytes_per_rung]
    for i in range(1, len(totals)):
        if totals[i] > totals[i - 1]:
            raise ValueError(
                f"ladder rung {i} costs {totals[i]:,} B/round, MORE than "
                f"rung {i - 1} ({totals[i - 1]:,} B/round) — order rungs "
                "most-expensive first (the realized cost can differ from "
                "the request, e.g. the sketch table's blocked layout; "
                f"per-rung totals: {totals})")

"""Seeded client-availability models — who shows up this round (the
reference's ``fedsim/availability.py``, draw for draw).

Each model emits a per-round ``[num_workers]`` boolean participation mask
as a pure function of ``(seed, round_idx)`` plus static knobs, so runs are
reproducible and resumable without serializing generator state — the same
discipline as ``FedSampler.sample_round``. Masks are over the round's
WORKER SLOTS (the sampler already decides which client fills each slot),
matching the reference's participation model where ``num_workers`` is the
participating fraction of ``num_clients``.

The rng stream is tuple-seeded with a distinct tag (``FEDSIM_STREAM``) so
availability draws can never perturb the sampler's batch draws: a
fedsim-masked run sees EXACTLY the batches the unmasked run would (that is
what makes the per-mode unbiasedness test meaningful — the only difference
between the two runs is who transmits).

Registry keyed by ``cfg.availability``; ``utils.config`` mirrors the names
in a literal tuple (``AVAILABILITY_MODELS``) pinned equal to this registry
by tests/test_torch_fedsim.py.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

# distinct rng stream tag: (seed, FEDSIM_STREAM, round_idx) can never
# collide with the sampler's (seed, round_idx) tuple seeds
FEDSIM_STREAM = 0xFED51

_REGISTRY: Dict[str, Callable] = {}


def register_availability(name: str):
    """Register an availability model under ``name`` (the cfg.availability
    value). Models are ``fn(rng, round_idx, *, num_workers, dropout_prob,
    period, num_cohorts, rate) -> bool [num_workers]`` — True = the slot's
    client is available this round."""

    def deco(fn):
        fn.availability_name = name
        _REGISTRY[name] = fn
        return fn

    return deco


def available_models() -> tuple:
    """Sorted registered model names (the config-validation mirror)."""
    return tuple(sorted(_REGISTRY))


def round_rng(seed: int, round_idx: int) -> np.random.Generator:
    """The round's fedsim rng — shared by the availability draw and the
    chaos draws (drawn in a fixed order), deterministic from
    ``(seed, round_idx)`` alone."""
    return np.random.default_rng((seed, FEDSIM_STREAM, round_idx))


def sample_availability(
    name: str,
    rng: np.random.Generator,
    round_idx: int,
    *,
    num_workers: int,
    dropout_prob: float = 0.0,
    period: int = 64,
    num_cohorts: int = 4,
    rate: float = 1.0,
) -> np.ndarray:
    """One round's availability mask from the named model."""
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown availability model {name!r}; registered: "
            f"{available_models()}"
        ) from None
    mask = fn(
        rng,
        round_idx,
        num_workers=num_workers,
        dropout_prob=dropout_prob,
        period=period,
        num_cohorts=num_cohorts,
        rate=rate,
    )
    return np.asarray(mask, bool)


@register_availability("always")
def _always(rng, round_idx, *, num_workers, dropout_prob, period,
            num_cohorts, rate):
    """Every client arrives every round — the reference's implicit model.
    The round masks nothing for it (cfg.fedsim_enabled is False), so this
    function only runs when composed under chaos."""
    return np.ones(num_workers, bool)


@register_availability("bernoulli")
def _bernoulli(rng, round_idx, *, num_workers, dropout_prob, period,
               num_cohorts, rate):
    """IID per-client dropout: each slot independently misses the round
    with probability ``dropout_prob``."""
    return rng.random(num_workers) >= dropout_prob


@register_availability("sine")
def _sine(rng, round_idx, *, num_workers, dropout_prob, period,
          num_cohorts, rate):
    """Diurnal participation: the per-client drop probability oscillates
    ``0 .. dropout_prob`` over ``period`` rounds (phones charge at night;
    FetchSGD §1's motivating deployment). Round 0 sits at the mean."""
    p = dropout_prob * 0.5 * (1.0 + np.sin(2.0 * np.pi * round_idx / period))
    return rng.random(num_workers) >= p


@register_availability("cohort")
def _cohort(rng, round_idx, *, num_workers, dropout_prob, period,
            num_cohorts, rate):
    """Correlated outages: worker slots are partitioned into
    ``num_cohorts`` groups (slot i -> cohort i % num_cohorts — a regional
    backbone / carrier model), and each cohort is out IN ITS ENTIRETY with
    probability ``dropout_prob`` per round. Same expected participation as
    bernoulli at equal prob, radically worse worst-case — exactly the
    correlation the all-dropped guard exists for."""
    out = rng.random(num_cohorts) < dropout_prob
    cohort_of = np.arange(num_workers) % num_cohorts
    return ~out[cohort_of]


@register_availability("poisson")
def _poisson(rng, round_idx, *, num_workers, dropout_prob, period,
             num_cohorts, rate):
    """Arrival-time availability: each slot's
    client draws an exponential arrival delay with rate ``rate``
    (``cfg.arrival_rate``, mean delay 1/rate in round-deadline units) and
    makes the round iff it arrives within one deadline — so the marginal
    participation probability is ``1 - exp(-rate)``, and ``rate -> inf``
    degenerates to ``always`` (delay 0). Composes with IID dropout
    (``dropout_prob``): a client can be reachable yet decline. Both draws
    happen unconditionally so the shared round rng's cursor — and
    therefore the chaos draws that follow it (env.py draw order) — is
    knob-independent."""
    scale = 0.0 if np.isinf(rate) else 1.0 / rate
    # unit draws scaled after the fact (not exponential(scale, .)) so the
    # rng cursor really is knob-independent even at rate=inf
    delays = rng.exponential(1.0, num_workers) * scale
    arrived = delays <= 1.0
    declined = rng.random(num_workers) < dropout_prob
    return arrived & ~declined

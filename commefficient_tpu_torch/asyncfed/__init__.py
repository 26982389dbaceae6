"""Buffered-asynchronous federation (``--async_buffer K``), the port's copy
of the reference's ``asyncfed/``.

FetchSGD's synchronous round waits for the slowest of W participants.
This package layers FedBuff-style buffered asynchrony (arXiv:2106.06639)
on the compress/EF/momentum pipeline: the server keeps ``C`` cohorts in
flight (``--async_concurrency``), fires an update once ``K``
contributions have arrived, and weights each by the staleness discount
``(1+s)^(-alpha)`` (``--staleness_exponent``) before it enters the
synchronous round's aggregation tail.

* ``schedule``: ``AsyncSchedule``, the pre-simulated arrival process
  (per-cohort exponential delays on their own rng stream, numpy only,
  equal to the reference's); everything downstream keys off its
  ``UpdateSpec``s.
* ``round``: ``build_async_round_fns``, the synchronous round split at
  the per-client/aggregate seam into a ``launch_fn`` (params -> the
  cohort's per-client transmit rows) and an ``apply_fn`` (the weighted
  sum -> K1's encode -> the server update, K2 or K4 in the decode), built
  from ``parallel/round.py``'s pieces, so K = W, C = 1, alpha = 0 is the
  synchronous round bit for bit.
* ``engine``: ``AsyncFederation``, the runner's round source (the
  protocol of ``pipeline.PipelinedRounds``) owning the in-flight window,
  the cohort staging (``pipeline.CohortScheduler``), the weights, the
  ``async/*`` telemetry, the control plane's decision point and retunes,
  and the vault's riders.

``--async_buffer 0`` (the default) builds nothing of it.
"""

from commefficient_tpu_torch.asyncfed.engine import AsyncFederation
from commefficient_tpu_torch.asyncfed.round import build_async_round_fns
from commefficient_tpu_torch.asyncfed.schedule import (
    ASYNC_STREAM,
    AsyncSchedule,
    UpdateSpec,
    cohort_delays,
)

__all__ = [
    "ASYNC_STREAM",
    "AsyncFederation",
    "AsyncSchedule",
    "UpdateSpec",
    "build_async_round_fns",
    "cohort_delays",
]

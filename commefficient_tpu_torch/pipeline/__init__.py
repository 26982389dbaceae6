"""Pipelined round execution (``--pipeline_depth > 0``): a round's host
work and its copy to the card leave the critical path.

Every input of a round (the sampler's draw and batch, the fedsim
environment, the lr) is a pure function of ``(seed, round)``, so round
t+1..t+depth can be realized ahead, bit-exactly:

* ``prefetch``: ``RoundPrefetcher``, a worker thread realizing
  ``RoundWork`` items up to ``depth`` rounds ahead, each staged on the card
  (``FederatedSession.stage_round_payload`` / ``stage_round_indices``:
  pinned buffers, a side stream, an event);
* ``engine``: ``PipelinedRounds``, the runner's round source at depth > 0,
  dispatching each staged round in order through the session.

At ``pipeline_depth 0`` nothing here is built: the runner's synchronous
loop reads ``data/sampler.py::prefetch`` instead. The control plane's
rung switches reach the engine through its switch listener (a counted
quiesce; the staged inputs do not depend on the rung). A hosted client
store's cohort rows are staged by the prefetch worker too
(``clientstore/``). ``cohorts``: ``CohortScheduler``, the prefetcher
realizing cohorts for the buffered-async engine (asyncfed/).
``scan_engine``: ``ScanRounds``, the runner's round source at
``scan_rounds > 1``: blocks of up to K rounds, each one replay of a CUDA
graph captured from the session's index round. At telemetry
level >= 1 the worker records its spans on its own lane and each round's
metrics carry the ``pipeline/*`` scalars.
"""

from commefficient_tpu_torch.pipeline.cohorts import CohortScheduler
from commefficient_tpu_torch.pipeline.engine import PipelinedRounds
from commefficient_tpu_torch.pipeline.prefetch import (
    PrefetchWorkerDied,
    RoundPrefetcher,
    RoundWork,
)
from commefficient_tpu_torch.pipeline.scan_engine import ScanRounds

__all__ = ["CohortScheduler", "PipelinedRounds", "PrefetchWorkerDied",
           "RoundPrefetcher", "RoundWork", "ScanRounds"]

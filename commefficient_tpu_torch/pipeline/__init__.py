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
loop reads ``data/sampler.py::prefetch`` instead. Not ported here (ROADMAP
A11 and A12): the compression controller's barrier and rung-switch
listener (``control/``), the hosted client rows' staging
(``clientstore/``), ``cohorts.py`` and ``scan_engine.py``. At telemetry
level >= 1 the worker records its spans on its own lane and each round's
metrics carry the ``pipeline/*`` scalars.
"""

from commefficient_tpu_torch.pipeline.engine import PipelinedRounds
from commefficient_tpu_torch.pipeline.prefetch import (
    PrefetchWorkerDied,
    RoundPrefetcher,
    RoundWork,
)

__all__ = ["PipelinedRounds", "PrefetchWorkerDied", "RoundPrefetcher",
           "RoundWork"]

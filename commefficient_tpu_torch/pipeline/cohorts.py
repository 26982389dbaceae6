"""CohortScheduler — the asyncfed cohort feed on the port's
``RoundPrefetcher`` (the port's copy of ``commefficient_tpu/pipeline/
cohorts.py``).

The buffered-asynchronous engine (asyncfed/engine.py) launches cohorts,
not rounds, and a cohort's host work is a round's: draw the participants,
assemble the batch, realize the fedsim environment, copy the arrays to the
card. So the scheduler IS a ``RoundPrefetcher`` with the step axis read as
the cohort index (the same worker thread, in-order ``get``, fault
propagation and replay fence), with two differences:

* a cohort's lr is ``lr_fn(launch_version[cohort])``, the server version
  the cohort launches against, not the cohort index (under concurrency
  C > 1 a cohort's launch version lags its index);
* it always stages the host batch (``use_indices=False``): the launch
  takes the staged batch whatever ``cfg.device_data`` says.

Its depth is ``max(1, C)``: C cohorts staged ahead keep C in flight with
no host work on the critical path. The staging ring's pinned buffers are
safe at any depth: a buffer's only reader is its own copy to the card,
and ``RoundStager`` hands a buffer out again only after the event recorded
after that copy has completed; the launch reads the copied device tensors,
which the dispatch records on its stream (``FederatedSession._consume``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from commefficient_tpu_torch.pipeline.prefetch import RoundPrefetcher, RoundWork


class CohortScheduler:
    """In-order cohort realization for the asyncfed engine: cohorts
    ``[start_cohort, stop_cohort)``, ``launch_versions[c]`` the version
    cohort ``c`` launches against, ``depth`` the cohorts staged ahead,
    ``replay_until`` the first cohort never realized before (the ones
    below realize their environment with ``replay=True``)."""

    def __init__(self, *, session, sampler, lr_fn,
                 launch_versions: Sequence[int], start_cohort: int = 0,
                 stop_cohort: int, depth: int, spans=None,
                 replay_until: int = 0):
        versions = tuple(int(v) for v in launch_versions)

        def cohort_lr(c: int) -> float:
            return float(lr_fn(versions[c]))

        self._prefetcher = RoundPrefetcher(
            session=session, sampler=sampler, lr_fn=cohort_lr,
            depth=max(1, int(depth)), start_step=int(start_cohort),
            stop_step=int(stop_cohort), use_indices=False, spans=spans,
            replay_until=int(replay_until))

    def start(self) -> "CohortScheduler":
        self._prefetcher.start()
        return self

    def get(self, cohort: int) -> RoundWork:
        """Cohort ``cohort``'s realized work (``RoundWork.step`` is the
        cohort index), in order; re-raises a worker fault."""
        return self._prefetcher.get(cohort)

    def close(self, timeout: Optional[float] = 10.0) -> None:
        self._prefetcher.close(timeout)

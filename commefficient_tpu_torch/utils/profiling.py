"""Profiling hooks (the port's copy of the reference's
``utils/profiling.py``): a ``torch.profiler`` trace around a window of
steady-state rounds, and the shared ``fence``/``timeit`` helpers.

``StepProfiler`` traces rounds ``[start, start + num_steps)`` into its
logdir through ``torch.profiler.tensorboard_trace_handler``, which writes
Chrome-trace JSON (viewable in Perfetto or ``chrome://tracing``) and needs
no ``tensorboard`` package. The window starts at least
``MIN_WARMUP_STEPS`` rounds after the first executed one, so it never
holds the first rounds' one-time work (the kernels' library load and
plans, cuDNN's algorithm search, the caching allocator's growth).
"""

from __future__ import annotations

import time

import torch

MIN_WARMUP_STEPS = 2


def fence(x) -> float:
    """Wait for the device work behind ``x`` (a tensor, or a dict, list or
    tuple of them) and return a scalar from its first tensor."""
    while isinstance(x, (dict, list, tuple)):
        x = next(iter(x.values())) if isinstance(x, dict) else x[0]
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[:1].sum())


def timeit(name, fn, *args, reps: int = 10, warmup: int = MIN_WARMUP_STEPS):
    """Mean ms a call of ``fn(*args)`` over ``reps`` calls, printed and
    returned: ``warmup`` calls first, one fence before and one after the
    timed loop (the calls queue back to back)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    fence(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    fence(out)
    dt = (time.perf_counter() - t0) / reps * 1e3
    print(f"{name:42s} {dt:8.2f} ms")
    return dt


class StepProfiler:
    """Trace rounds ``[start_step, start_step + num_steps)`` into
    ``logdir``.

    Call ``step(i)`` as each round is dispatched (monotonic ``i``),
    ``resume_at(step0)`` after a checkpoint restore, ``close()`` in a
    ``finally``. Inert when ``logdir`` is falsy.

    The trace starts at the first ``step()`` that lands INSIDE the window
    (a resume that fast-forwards into its middle still traces the rest)
    and stops at the first step at or past its end; ``start_step`` is
    clamped to at least ``MIN_WARMUP_STEPS``."""

    def __init__(self, logdir: str, start_step: int = 5, num_steps: int = 3):
        self.logdir = logdir
        self.num_steps = num_steps
        self.start = max(start_step, MIN_WARMUP_STEPS)
        self.stop_at = self.start + num_steps
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def resume_at(self, resume_step: int) -> None:
        """Clamp the window to the rounds after a resume at
        ``resume_step``: the resumed process's first round pays the
        one-time work again, so a window overlapping or before it moves
        to ``resume_step + MIN_WARMUP_STEPS`` (same length)."""
        floor = resume_step + MIN_WARMUP_STEPS
        if floor > self.start:
            self.start = floor
            self.stop_at = floor + self.num_steps

    def step(self, step_idx: int) -> None:
        if not self.logdir:
            return
        if self.active and step_idx >= self.stop_at:
            self._stop()
        elif not self.active and self.start <= step_idx < self.stop_at:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.logdir))
            self._prof.start()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()  # writes the trace through on_trace_ready

    def close(self) -> None:
        if self.active:
            self._stop()

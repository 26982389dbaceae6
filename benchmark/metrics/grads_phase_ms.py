"""``grads_phase_ms``: the median over the traced window's rounds of the
round function's first phase, the clients' gradients and transmits,
between its own ``mark(0)`` and ``mark(1)`` (CUDA events). None where
the rounds are graph replays, which carry no marks."""

import statistics


def read(ctx):
    ph = ctx.window["phases_ms"]
    return statistics.median(p[0] for p in ph) if ph else None

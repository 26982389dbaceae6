"""``server_phase_ms``: the median over the traced window's rounds of the
round function's server phase (the compressor's server update: for
sketch the table algebra, the decode, the top-k and the error
feedback's re-sketch), between ``mark(2)`` and ``mark(3)``."""

import statistics


def read(ctx):
    ph = ctx.window["phases_ms"]
    return statistics.median(p[2] for p in ph) if ph else None

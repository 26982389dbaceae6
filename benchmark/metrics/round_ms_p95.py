"""``round_ms_p95``: the 95th percentile (nearest rank) over all of the
window's rounds of a round's time, the gap between its completion event
and the previous round's (the first round's: from the window's opening
event). Only where rounds complete one at a time: a graph replay
completes several together. A per-layer reading beside
``round_ms.per_round``: its stalls (the collector's, the host's) swing
between runs by more than an end-to-end bound could hold."""

import math


def read(ctx):
    gaps = sorted(ctx.window["gaps_ms"])
    return gaps[math.ceil(0.95 * len(gaps)) - 1]

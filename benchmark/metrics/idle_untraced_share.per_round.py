"""``idle_untraced_share.per_round``: ``idle_untraced_share``
(``idle_untraced_share.py``) in the cells dispatched round by round,
where it moves ``round_ms.per_round``."""

from benchmark.harness.spec import reader


def read(ctx):
    return reader("idle_untraced_share").read(ctx)

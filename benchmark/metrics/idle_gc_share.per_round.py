"""``idle_gc_share.per_round``: ``idle_gc_share`` (``idle_gc_share.py``)
in the cells dispatched round by round, where it moves
``round_ms.per_round``."""

from benchmark.harness.spec import reader


def read(ctx):
    return reader("idle_gc_share").read(ctx)

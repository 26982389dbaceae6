"""``countsketch_roofline.per_round``: ``countsketch_roofline`` (``countsketch_roofline.py``) in the cells
dispatched round by round, where it moves ``round_ms.per_round``."""

from benchmark.harness.spec import reader


def read(ctx):
    return reader("countsketch_roofline").read(ctx)

"""``device_idle_share.per_round``: ``device_idle_share`` (``device_idle_share.py``) in the cells
dispatched round by round, where it moves ``round_ms.per_round``."""

from benchmark.harness.spec import reader


def read(ctx):
    return reader("device_idle_share").read(ctx)

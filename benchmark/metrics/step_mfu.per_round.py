"""``step_mfu.per_round``: ``step_mfu`` (``step_mfu.py``) in the cells
dispatched round by round, where it moves ``round_ms.per_round``."""

from benchmark.harness.spec import reader


def read(ctx):
    return reader("step_mfu").read(ctx)

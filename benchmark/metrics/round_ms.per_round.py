"""``round_ms.per_round``: ``round_ms`` (``round_ms.py``) in the cells
dispatched round by round, whose round time the host's speed moves, so
that they are gated apart from the cells that replay rounds ahead."""

from benchmark.harness.spec import reader


def read(ctx):
    return reader("round_ms").read(ctx)

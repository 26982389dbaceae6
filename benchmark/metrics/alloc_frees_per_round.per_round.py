"""``alloc_frees_per_round.per_round``: ``alloc_frees_per_round``
(``alloc_frees_per_round.py``) in the cells dispatched round by round,
where it moves ``round_ms.per_round``."""

from benchmark.harness.spec import reader


def read(ctx):
    return reader("alloc_frees_per_round").read(ctx)

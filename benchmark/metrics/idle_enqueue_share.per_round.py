"""``idle_enqueue_share.per_round``: the percent of a traced window in
which the device is idle while the host is inside the round's
``round_dispatch`` span or its ``round.grads``, ``round.encode``,
``round.server`` and ``round.apply`` children, and no collection runs
(the host enqueuing slower than the card runs), from
``harness/program_trace.py``'s window. None where the program records no
detail."""

from benchmark.harness import program_trace


def read(ctx):
    t = program_trace.read(ctx)
    return None if t is None else t["shares"]["enqueue"]

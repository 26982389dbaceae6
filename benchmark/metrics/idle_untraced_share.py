"""``idle_untraced_share``: the percent of a traced window in which the
device is idle while the host is inside the round source's ``next()``
(the harness's ``dispatch`` and ``epoch_staging`` ranges) and no program
span is open: the idle time the program's spans leave unexplained, from
``harness/program_trace.py``'s window. None where the program records no
detail."""

from benchmark.harness import program_trace


def read(ctx):
    t = program_trace.read(ctx)
    return None if t is None else t["shares"]["untraced"]

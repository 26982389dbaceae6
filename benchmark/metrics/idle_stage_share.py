"""``idle_stage_share``: the percent of a traced window in which the
device is idle while the host is inside the scan engine's
``scan_stage`` span (an epoch's ids, indices and plans staged) and no
collection runs, from ``harness/program_trace.py``'s window. None where
the program records no detail."""

from benchmark.harness import program_trace


def read(ctx):
    t = program_trace.read(ctx)
    return None if t is None else t["shares"]["stage"]

"""``idle_gc_share``: the percent of a traced window in which the device
is idle while a ``gc`` span is open (a collection of Python's collector,
recorded by the program's detailed ``PhaseSpans``), from
``harness/program_trace.py``'s window. None where the program records no
detail."""

from benchmark.harness import program_trace


def read(ctx):
    t = program_trace.read(ctx)
    return None if t is None else t["shares"]["gc"]

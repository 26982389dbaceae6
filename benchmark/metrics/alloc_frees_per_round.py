"""``alloc_frees_per_round``: the caching allocator's ``num_device_free``
plus ``num_alloc_retries`` over the rounds of a traced window, per round
(a scan engine's replay counts its rounds), from the deltas the
program's detailed ``PhaseSpans`` puts on each ``round_dispatch`` span
(``harness/program_trace.py``'s window). Each is a ``cudaFree`` or a
retry, and each synchronizes the device. None where the program records
no detail."""

from benchmark.harness import program_trace


def read(ctx):
    t = program_trace.read(ctx)
    return None if t is None else t["alloc_frees_per_round"]

"""``setup_s``: from the benchmark's start (its first statement) to the
window's first round: imports, weights and data, the program's build
(kernels compiled on a checkout's first run), the first rounds and the
warm-up."""


def read(ctx):
    return ctx.setup_s

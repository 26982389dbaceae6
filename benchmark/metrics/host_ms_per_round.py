"""``host_ms_per_round``: the host's time inside the round source's
``next()`` (the runner's dispatch: sampling, staging, launches or a
graph replay), summed over the traced run's window, per round."""


def read(ctx):
    return 1e3 * sum(ctx.window["host_s"]) / ctx.window["rounds"]

"""``step_mfu``: the model's forward and backward FLOPs of a round,
counted from shapes (``yardstick/flops.py``), times the rounds completed
in the traced run's window, over the window's seconds, over the dense
peak of the precision the configuration computes in
(``yardstick/peaks.py``), in %."""

from benchmark.yardstick import flops, peaks


def read(ctx):
    w = ctx.window
    if not w["rounds"]:
        return None
    rate = flops.per_round(ctx.cell.config, ctx.cell.traffic) * \
        w["rounds"] / w["seconds"]
    return 100.0 * rate / peaks.DENSE_FLOPS[ctx.cell.config["peak_precision"]]

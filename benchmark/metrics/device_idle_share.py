"""``device_idle_share``: 100 x (1 - the union of the device's kernel
intervals over the traced window's length), from ``torch.profiler``."""


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

"""``round_ms``: the window's length over the rounds completed in it
(host clock; the window opens after a device synchronize and closes on
one, so every round dispatched in it completed in it)."""


def read(ctx):
    return 1e3 * ctx.window["seconds"] / ctx.window["rounds"]

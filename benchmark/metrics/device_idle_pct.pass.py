"""Share of the traced window in which the device ran nothing, in percent
(mean over the cell's devices)."""


def read(ctx):
    return ctx.idle_pct()

"""The whole request's share of its roofline, in percent.

The floor of one request is the larger of the bytes it cannot avoid over
the cell's chips' memory bandwidth and its operations over their ceiling
rate (the peaks table's ``flops_ceiling``, a rate no implementation at any
precision exceeds). The share is that floor times the requests completed in
the traced window, over the device busy time (mean over the devices).
"""


def read(ctx):
    busy = ctx.busy_s()
    if not ctx.completed or not busy or not any(busy):
        return None
    peaks = ctx.peaks
    floor_s = max(ctx.work["bytes"] / (ctx.chips * peaks["hbm_bytes_per_s"]),
                  ctx.work["flops"]
                  / (ctx.chips * peaks[peaks["flops_ceiling"]]))
    return 100.0 * floor_s * ctx.completed / (sum(busy) / len(busy))

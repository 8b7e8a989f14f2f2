"""Device time of the ``gemm`` layer, summed over devices, per minute of
audio completed in the traced window, in microseconds per minute."""


def read(ctx):
    per = ctx.layer_s().get("gemm")
    if not per or not ctx.audio_s:
        return None
    return sum(per.values()) * 1e6 / (ctx.audio_s / 60.0)

"""Device time of the ``frame`` layer, summed over devices, per minute of
audio completed in the traced window, in microseconds per minute."""


def read(ctx):
    per = ctx.layer_s().get("frame")
    if not per or not ctx.audio_s:
        return None
    return sum(per.values()) * 1e6 / (ctx.audio_s / 60.0)

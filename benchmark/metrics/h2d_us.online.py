"""Device time of host-to-device copies per completed request, in
microseconds (layer ``h2d``)."""


def read(ctx):
    per = ctx.layer_s().get("h2d")
    if not per or not ctx.completed:
        return None
    return sum(per.values()) / ctx.completed * 1e6

"""Device time of exchanges between devices (layer ``collective``) per
completed request, in milliseconds, on the device that spent most."""


def read(ctx):
    per = ctx.layer_s().get("collective")
    if not per or not ctx.completed:
        return None
    return max(per.values()) / ctx.completed * 1e3

"""Device milliseconds per single-image UNet-forward equivalent (a backward
counts two): the traced batch's busy device time over its equivalents."""


def read(ctx):
    if ctx.get("kind") != "edit" or not ctx.get("fwd_equivalents"):
        return None
    return 1000.0 * ctx["trace"].busy_s / ctx["fwd_equivalents"]

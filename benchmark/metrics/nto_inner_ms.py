"""Milliseconds of null-text optimization per inner iteration: the seconds
``RunLog`` charged to the phase over the untraced window, over the inner
iterations the loop ran (a batch's iteration counts once)."""


def read(ctx):
    if ctx.get("kind") != "edit" or not ctx.get("nto_inner"):
        return None
    return 1000.0 * ctx["nto_s"] / ctx["nto_inner"]

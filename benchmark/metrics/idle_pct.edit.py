"""The device's idle share (%) of the traced edit batch: one minus the
union of its operations' intervals over the whole traced window."""


def read(ctx):
    if ctx.get("kind") != "edit":
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

"""The device's idle share (%) of the traced training steps: one minus the
union of its operations' intervals over the whole traced window."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

"""Milliseconds per guided sampling step (CFG pair, scheduler step, midu
guidance gradient) of a batch: ``RunLog``'s seconds for the phase over the
untraced window, over its steps."""


def read(ctx):
    if ctx.get("kind") != "edit" or not ctx.get("sample_steps"):
        return None
    return 1000.0 * ctx["sample_s"] / ctx["sample_steps"]

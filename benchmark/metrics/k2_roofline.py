"""K2's share of its roofline (%): the least time of the traced batch's
flash-attention launches, from the benchmark's own count of their operations
and bytes at the launched shapes, over the device time of the kernels whose
names say flash attention. Nothing where no K2 kernel ran."""

PARTS = ("flash_fwd", "flash_bwd")


def read(ctx):
    least = ctx.get("k2_least_s")
    if not least:
        return None
    seconds = ctx["trace"].seconds_matching(*PARTS)
    if seconds <= 0:
        return None
    return 100.0 * least / seconds

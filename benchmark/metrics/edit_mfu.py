"""The edit's model FLOPs utilization (%): the FLOPs of the calls the
untraced window made (counted on the plain networks, kind by kind) over its
wall seconds and the bf16 dense peak."""

from benchmark.common import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "edit":
        return None
    return 100.0 * ctx["flops"] / ctx["wall_s"] / PEAK_BF16_FLOPS

"""Midu training's model FLOPs utilization (%): the FLOPs of the steps the
untraced window made (teacher, VAE encode, UNet, midu forward and backward,
counted on the plain networks) over its wall seconds and the bf16 dense
peak."""

from benchmark.common import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return 100.0 * ctx["flops"] / ctx["wall_s"] / PEAK_BF16_FLOPS

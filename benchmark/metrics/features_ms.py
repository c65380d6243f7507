"""Milliseconds of ``features_and_labels`` (teacher labels, VAE encode,
noise, the UNet to its mid block) per training batch: the benchmark's own
span, synchronised at both ends, averaged over a second window."""


def read(ctx):
    spans = ctx.get("features_s")
    if ctx.get("kind") != "train" or not spans:
        return None
    return 1000.0 * sum(spans) / len(spans)

"""``idle_pct.edit`` in the cells that report ``s_per_image.xl``."""

from benchmark.common import metric_reader

read = metric_reader("idle_pct.edit")

"""``guided_step_ms`` in the cells that report ``s_per_image.xl``."""

from benchmark.common import metric_reader

read = metric_reader("guided_step_ms")

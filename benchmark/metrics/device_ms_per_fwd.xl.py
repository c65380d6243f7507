"""``device_ms_per_fwd`` in the cells that report ``s_per_image.xl``."""

from benchmark.common import metric_reader

read = metric_reader("device_ms_per_fwd")

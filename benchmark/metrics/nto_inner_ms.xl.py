"""``nto_inner_ms`` in the cells that report ``s_per_image.xl``."""

from benchmark.common import metric_reader

read = metric_reader("nto_inner_ms")

"""``edit_mfu`` in the cells that report ``s_per_image.xl``."""

from benchmark.common import metric_reader

read = metric_reader("edit_mfu")

"""Data parallelism over processes, one device each (``torch.distributed``)."""

from rgie_tpu_torch.parallel.distributed import (all_processes_barrier, init_distributed,
                                                 is_main_process, process_device, process_info,
                                                 split_batch, spawn_ranks)
from rgie_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_mean,
                                          create_hybrid_mesh, create_mesh, pad_to_multiple)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "all_mean", "all_processes_barrier",
           "create_hybrid_mesh", "create_mesh", "init_distributed", "is_main_process",
           "pad_to_multiple", "process_device", "process_info", "split_batch", "spawn_ranks"]

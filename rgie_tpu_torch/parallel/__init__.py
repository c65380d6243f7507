"""Processes over a (data, model) mesh, one device each (``torch.distributed``):
data parallelism, and tensor parallelism over weight output channels."""

from rgie_tpu_torch.parallel.distributed import (all_processes_barrier, init_distributed,
                                                 is_main_process, process_device, process_info,
                                                 split_batch, spawn_ranks)
from rgie_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_mean,
                                          create_hybrid_mesh, create_mesh, model_sharding,
                                          pad_to_multiple, rank_grid)
from rgie_tpu_torch.parallel.model_axis import model_axis_of, shard_model

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "all_mean", "all_processes_barrier",
           "create_hybrid_mesh", "create_mesh", "init_distributed", "is_main_process",
           "model_axis_of", "model_sharding", "pad_to_multiple", "process_device",
           "process_info", "rank_grid", "shard_model", "split_batch", "spawn_ranks"]

"""Parallelism over ``torch.distributed`` (counterpart of
``aloception_tpu/parallel``): the mesh, the sharding rules, the GPipe
pipeline and the process-group bring-up. ``python -m
aloception_tpu_torch.parallel.dryrun N`` checks them on N CPU processes."""

from .mesh import (current_mesh, default_mesh_shape,  # noqa: F401
                   make_mesh, mesh_shape, use_mesh)
from .shard import (constrain_tokens, param_partition_spec,  # noqa: F401
                    partition_params, replicate, shard_batch)
from .pipeline import (extract_layer_stack, gpipe,  # noqa: F401
                       shard_layer_stack, stack_layer_params)
from .distributed import (init_multihost, is_main_process,  # noqa: F401
                          local_device_count, main_process_only,
                          process_count)

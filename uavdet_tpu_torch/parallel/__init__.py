"""Multi-device training and detection of the port over ``torch.distributed``:
the ``data`` x ``fsdp`` mesh (DDP, FSDP2, HSDP), BatchNorm over the global
batch, the process start-up and per-rank batches. The JAX package's
``parallel/`` for those two axes; ``sp``, ``ep`` and ``pp`` are refused
(``check_layout_supported``)."""
from .batchnorm import global_batch_norm
from .mesh import (BATCH_AXES, all_gather_rows, batch_group,
                   batch_group_size, batch_index, check_batch_divisible,
                   check_layout_supported, copy_full_weights, gradient_sync,
                   make_mesh, row_block, shard_model, unwrap)
from .multihost import (backend_for, init_multihost, is_writer,
                        local_batch_rows, local_device, local_rows_of,
                        mesh_from_env, shard_host_batch)

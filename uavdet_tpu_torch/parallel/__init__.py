"""Multi-device training and detection of the port: over
``torch.distributed``, the ``data`` x ``fsdp`` x ``sp`` x ``ep`` mesh (DDP,
FSDP2, HSDP; halo exchanges of image rows; expert slices), BatchNorm over
the global batch, the process start-up and per-rank batches; in one
process, ``pp``, the stages of the layer_config interpreter on their
devices (``pipeline.py``). The JAX package's ``parallel/``."""
from .batchnorm import global_batch_norm
from .experts import (cut_expert_tensor, expert_params, full_expert_tensor,
                      reduce_expert_grads, shard_experts)
from .mesh import (BATCH_AXES, all_gather_rows, batch_group,
                   batch_group_size, batch_index, check_batch_divisible,
                   check_layout_supported, coordinate, copy_full_weights,
                   ep_group, gradient_sync, make_mesh, row_block,
                   same_slice_group, shard_model, sp_group, unwrap)
from .multihost import (backend_for, init_multihost, is_writer,
                        local_batch_rows, local_device, local_rows_of,
                        mesh_from_env, shard_host_batch)
from .spatial import (gather_rows, halo_exchange, model_stride, row_band,
                      set_sp_group, sp_rows, sp_sum)
from .pipeline import (PipelinedModel, PipelineStage, make_pp_eval_step,
                       make_pp_loss, make_pp_train_step,
                       make_pp_trainer_step, split_tokens, stage_devices)

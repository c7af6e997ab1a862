"""The port's parallel layer over torch.distributed (port of
parq_tpu/parallel/): process-group bring-up and rank-0 gating
(`multihost`), the (data, model) grid of ranks (`mesh`),
sequence-parallel cross-attention over the model group (`seq_parallel`),
tensor parallelism of the decoder's FFN and self-attention over it
(`tensor_parallel`), and the twin of the JAX package's multi-chip dry run
(`dryrun`)."""
from .dryrun import dryrun_multichip
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, replicated, \
    shard_batch
from .multihost import (host_shard_indices, initialize_distributed,
                        is_main_process)
from .seq_parallel import (sp_flash_cross_attention,
                           sp_flash_cross_attention_fwd_lse,
                           sp_flash_cross_attention_kv_fused,
                           sp_flash_cross_attention_precomputed)
from .tensor_parallel import (all_reduce_sum, full_optimizer_state,
                              full_state_dict, param_sharding_rules,
                              shard_model_, shard_optimizer_state,
                              shard_state_dict)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "all_reduce_sum",
           "dryrun_multichip", "full_optimizer_state", "full_state_dict",
           "host_shard_indices", "initialize_distributed", "is_main_process",
           "make_mesh", "param_sharding_rules", "replicated", "shard_batch",
           "shard_model_", "shard_optimizer_state", "shard_state_dict",
           "sp_flash_cross_attention", "sp_flash_cross_attention_fwd_lse",
           "sp_flash_cross_attention_kv_fused",
           "sp_flash_cross_attention_precomputed"]

"""The port's parallel layer over torch.distributed (port of
parq_tpu/parallel/): process-group bring-up and rank-0 gating
(`multihost`), the (data, model) grid of ranks (`mesh`), and
sequence-parallel cross-attention over the model group
(`seq_parallel`)."""
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, replicated, \
    shard_batch
from .multihost import (host_shard_indices, initialize_distributed,
                        is_main_process)
from .seq_parallel import (sp_flash_cross_attention,
                           sp_flash_cross_attention_fwd_lse,
                           sp_flash_cross_attention_kv_fused,
                           sp_flash_cross_attention_precomputed)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "host_shard_indices",
           "initialize_distributed", "is_main_process", "make_mesh",
           "replicated", "shard_batch", "sp_flash_cross_attention",
           "sp_flash_cross_attention_fwd_lse",
           "sp_flash_cross_attention_kv_fused",
           "sp_flash_cross_attention_precomputed"]

"""Hand-written CUDA kernels of the port, each beside its plain version.

| TPU kernel (parq_tpu/kernels)       | here                                  |
|-------------------------------------|---------------------------------------|
| pixel_align_pallas._pallas_sample   | pixel_align.sample_views (B1)         |
| cross_attention_pallas._fwd_call    | cross_attention.flash_cross_attention_kv_fused (B2, eval form) and cross_attention.flash_fwd_lse (B2, train form) |
| cross_attention_pallas._bwd_call    | cross_attention.flash_bwd (B3)        |
| pixel_align_pallas._pallas_sample_bwd_mem | pixel_align.sample_views_bwd_mem (B4) |

Each wrapper counts its launches in a ``launches`` attribute.
`SERVE_KERNELS` are the ones a forward for serving launches; the training
step launches all but the eval form of B2.
"""
from .cross_attention import (flash_bwd, flash_cross_attention_kv_fused,
                              flash_fwd_lse)
from .pixel_align import (pixel_aligned_features_kernel, sample_views,
                          sample_views_bwd_mem)

KERNELS = {
    "pixel_align_sample": sample_views,
    "flash_cross_attention_fwd": flash_cross_attention_kv_fused,
    "flash_cross_attention_fwd_train": flash_fwd_lse,
    "flash_cross_attention_bwd": flash_bwd,
    "pixel_align_bwd_mem": sample_views_bwd_mem,
}
SERVE_KERNELS = ("pixel_align_sample", "flash_cross_attention_fwd")


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "SERVE_KERNELS", "flash_bwd",
           "flash_cross_attention_kv_fused", "flash_fwd_lse",
           "launch_counts", "pixel_aligned_features_kernel",
           "reset_launch_counts", "sample_views", "sample_views_bwd_mem"]

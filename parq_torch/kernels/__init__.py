"""Hand-written CUDA kernels of the port, each beside its plain version.

| TPU kernel (parq_tpu/kernels)       | here                                  |
|-------------------------------------|---------------------------------------|
| pixel_align_pallas._pallas_sample   | pixel_align.sample_views (B1)         |
| cross_attention_pallas._fwd_call    | cross_attention.flash_cross_attention_kv_fused (B2, eval form) |

Each wrapper counts its launches in a ``launches`` attribute.
"""
from .cross_attention import flash_cross_attention_kv_fused
from .pixel_align import pixel_aligned_features_kernel, sample_views

KERNELS = {
    "pixel_align_sample": sample_views,
    "flash_cross_attention_fwd": flash_cross_attention_kv_fused,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "flash_cross_attention_kv_fused", "launch_counts",
           "pixel_aligned_features_kernel", "reset_launch_counts",
           "sample_views"]

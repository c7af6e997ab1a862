"""Hand-written CUDA kernels of the port, each beside its plain version.

| TPU kernel (parq_tpu/kernels)       | here                                  |
|-------------------------------------|---------------------------------------|
| pixel_align_pallas._pallas_sample   | pixel_align.sample_views (B1)         |
| cross_attention_pallas._fwd_call    | cross_attention.flash_cross_attention_kv_fused (B2, eval form) and cross_attention.flash_fwd_lse (B2, train form) |
| cross_attention_pallas._bwd_call    | cross_attention.flash_bwd (B3)        |
| pixel_align_pallas._pallas_sample_bwd_mem | pixel_align.sample_views_bwd_mem (B4) |

B2 and B3 in bf16 at the release head dim (256) are the Hopper kernels of
``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu`` (wgmma on TMA-fed
shared-memory rings, the forward's KV range split over CTAs by
`cross_attention.kv_splits`); f32, and bf16 at head dims 64 and 128, run
the SIMT and mma.sync kernels of ``csrc/cross_attention.cu``. B4
(``csrc/pixel_align_bwd.cu``) is a per-pixel gather: one CTA per 8x8 tile
of a map lists the query rows that touch the tile and each pixel sums its
taps in f32 registers in q order and is written once in the memory's
dtype: no scratch, no atomics, the same bits from run to run.

The CLI twins (``parq_torch/cli``) and the config tree
(``parq_torch/config``) changed no kernel: `Trainer.fit` launches B1,
B2-train, B3 and B4 every step and `Trainer.validate` B1 and B2.

Each wrapper counts its launches in a ``launches`` attribute (a split
forward with its combine kernel is one launch).
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

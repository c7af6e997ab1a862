"""Hand-written CUDA kernels of the port, each beside its plain version.

| TPU kernel (parq_tpu/kernels)       | here                                  |
|-------------------------------------|---------------------------------------|
| pixel_align_pallas._pallas_sample   | pixel_align.sample_views (B1)         |
| cross_attention_pallas._fwd_call    | cross_attention.flash_cross_attention_kv_fused (B2, eval form) and cross_attention.flash_fwd_lse (B2, train form) |
| cross_attention_pallas._bwd_call    | cross_attention.flash_bwd (B3)        |
| the same two, K and V as two buffers (kv_fused=False) | cross_attention.flash_fwd_lse_kv and flash_bwd_kv |
| pixel_align_pallas._pallas_sample_bwd_mem | pixel_align.sample_views_bwd_mem (B4) |
| ops/hungarian.solve_lap (lax loops, no pallas_call) | lap.solve_lap (M1) |

B2 and B3 in bf16 at the release head dim (256) are the Hopper kernels of
``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu`` (wgmma on TMA-fed
shared-memory rings, the forward's KV range split over CTAs by
`cross_attention.kv_splits`); f32, and bf16 at head dims 64 and 128, run
the SIMT and mma.sync kernels of ``csrc/cross_attention.cu``. B4
(``csrc/pixel_align_bwd.cu``) is a per-pixel gather: one CTA per 8x8 tile
of a map lists the query rows that touch the tile and each pixel sums its
taps in f32 registers in q order and is written once in the memory's
dtype: no scratch, no atomics, the same bits from run to run. B1
(``csrc/pixel_align.cu``) stages a CTA's (u, v) rows in shared memory and
loads every view's taps before its first FMA; it writes the memory's
dtype. M1 (``csrc/lap.cu``) solves the matcher's assignments on the card,
one warp per (iteration, sample) pair on cost rows staged in shared
memory, in JAX's f32 arithmetic: the train step no longer copies its
costs to the host.

The CLI twins (``parq_torch/cli``) and the config tree
(``parq_torch/config``) changed no kernel: `Trainer.fit` launches B1,
B2-train, B3, B4 and M1 every step and `Trainer.validate` B1, B2 and M1
(the validation loss runs the matcher).

K and V as two buffers (the natural and legacy layouts, the
sequence-parallel training path) run the same kernels on other strides,
through their own wrappers and counts.

Each wrapper counts its launches in a ``launches`` attribute (a split
forward with its combine kernel is one launch). B1 and the eval form of
B2 run through the custom ops ``parq::sample_views`` and
``parq::flash_kv_fused`` (registered when this package is imported), so a
`torch.export` program of the eval forward (`parq_torch.export`) launches
them, and counts them, as the live model does.
`SERVE_KERNELS` are the ones a forward for serving launches; the training
step launches all but the eval form of B2.
"""
from .cross_attention import (flash_bwd, flash_bwd_kv,
                              flash_cross_attention_kv_fused, flash_fwd_lse,
                              flash_fwd_lse_kv)
from .lap import solve_lap
from .pixel_align import (pixel_aligned_features_kernel, sample_views,
                          sample_views_bwd_mem)

KERNELS = {
    "pixel_align_sample": sample_views,
    "flash_cross_attention_fwd": flash_cross_attention_kv_fused,
    "flash_cross_attention_fwd_train": flash_fwd_lse,
    "flash_cross_attention_bwd": flash_bwd,
    "pixel_align_bwd_mem": sample_views_bwd_mem,
    "flash_cross_attention_fwd_train_split": flash_fwd_lse_kv,
    "flash_cross_attention_bwd_split": flash_bwd_kv,
    "lap_solve": solve_lap,
}
SERVE_KERNELS = ("pixel_align_sample", "flash_cross_attention_fwd")


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "SERVE_KERNELS", "flash_bwd", "flash_bwd_kv",
           "flash_cross_attention_kv_fused", "flash_fwd_lse",
           "flash_fwd_lse_kv",
           "launch_counts", "pixel_aligned_features_kernel",
           "reset_launch_counts", "sample_views", "sample_views_bwd_mem",
           "solve_lap"]

"""Hand-written CUDA kernels of the port, each beside its plain version.

| TPU kernel (parq_tpu/kernels)       | here                                  |
|-------------------------------------|---------------------------------------|
| pixel_align_pallas._pallas_sample   | pixel_align.sample_views (B1)         |
| cross_attention_pallas._fwd_call    | cross_attention.flash_cross_attention_kv_fused (B2, eval form) and cross_attention.flash_fwd_lse (B2, train form) |
| cross_attention_pallas._bwd_call    | cross_attention.flash_bwd (B3)        |
| the same two, K and V as two buffers (kv_fused=False) | cross_attention.flash_fwd_lse_kv and flash_bwd_kv |
| pixel_align_pallas._pallas_sample_bwd_mem | pixel_align.sample_views_bwd_mem (B4) |
| ops/hungarian.solve_lap (lax loops, no pallas_call) | lap.solve_lap (M1) |
| models/decoder._grouped_keep (jax.random, no pallas_call) | dropout.draw_keep (the keep masks) |
| models/mlp.fused_detection_heads (XLA, no pallas_call) | heads.detection_heads (the four heads and the box decode) |
| (none: the JAX package has no deformable convolution) | deform_conv.deform_columns (PETR's DCNv2 im2col) |
| models/resnet_fpn (frozen BN, ReLU, adds: XLA fusions, no pallas_call) | frozen_bn.frozen_bn_site (a BN site of the ResNet body) |
| evals/nms.nms_mask_device (plain JAX, no pallas_call) | nms.nms_pack (parse_pred's greedy NMS and the pack of its detections) |
| (none: the JAX package has no deformable attention) | ms_deform_attn.ms_deform_attn (BEVFormer's multi-scale deformable attention) |

B2 and B3 in bf16 at the release head dim (256) are the Hopper kernels of
``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu`` (wgmma on TMA-fed
shared-memory rings, the forward's KV range split over CTAs by
`cross_attention.kv_splits` and B3's dq pass's by `dq_splits`); f32, and bf16 at head dims 64 and 128, run
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
costs to the host. The keep-mask kernel (``csrc/dropout.cu``) draws the
decoder's dropout masks from device seeds with the flash kernels' v1
counter hash, so the training step reads nothing back. The heads kernels
(``csrc/heads.cu``) run a decoder iteration's four detection heads and its
box decode in three launches (two wgmma products with GroupNorm statistics
from their tiles' epilogues, then the f32 projections and the decode) in
the bf16 eval forward on the card; training, f32 and the CPU keep the
per-head modules (`heads.engages`). The frozen-BN kernel
(``csrc/frozen_bn.cu``) applies a BN site of the ResNet body, with its
residual add and ReLU, in one pass over a channels-last bf16 map, bit for
bit as the modules' ops wherever no gradient is recorded (a frozen body
in training too); a body that trains, f32, the CPU and NCHW maps keep
the modules' ops (`frozen_bn.engages`). The NMS kernel
(``csrc/nms.cu``) runs parse_pred's greedy 3D NMS on the card, one CTA a
sample, in the host library's f64 arithmetic (its keep mask is
`native.nms3d`'s bit for bit), while CTAs beside it pack the detections
into one buffer, so that parse_pred's host half makes one copy; CPU
tensors keep the host route. The MSDA kernel (``csrc/ms_deform_attn.cu``)
takes BEVFormer's three deformable attentions a layer (the spatial
cross-attention over each query's cameras, the temporal self-attention
over the previous and current BEV, the decoder's over the BEV), one warp
a (query, head), the softmax, the sampling locations and the frames'
combination in the same pass.

The CLI twins (``parq_torch/cli``) and the config tree
(``parq_torch/config``) changed no kernel: `Trainer.fit` launches B1,
B2-train, B3, B4 and M1 every step and `Trainer.validate` B1, B2 and M1
(the validation loss runs the matcher).

K and V as two buffers (the natural and legacy layouts, the
sequence-parallel training path) run the same kernels on other strides,
through their own wrappers and counts.

Each wrapper counts its launches in a ``launches`` attribute (a split
forward with its combine kernel is one launch; so is a heads call's three
kernels). B1, the eval form of B2 and the heads run through the custom ops ``parq::sample_views``,
``parq::flash_kv_fused`` and ``parq::detection_heads`` (registered when
this package is imported), so a
`torch.export` program of the eval forward (`parq_torch.export`) launches
them, and counts them, as the live model does.
`SERVE_KERNELS` are the ones a forward for serving launches; the training
step launches all but the eval form of B2 and the heads. A CUDA graph's replay runs no
Python: the graph layer (``parq_torch/graphs.py``) keeps, for each
captured graph, the launches of one replay (`GraphLaunches`) and counts its
replays, and `launch_counts` adds replays × launches to the wrappers'
counters when asked.
"""
from .cross_attention import (flash_bwd, flash_bwd_kv,
                              flash_cross_attention_kv_fused, flash_fwd_lse,
                              flash_fwd_lse_kv)
from .deform_conv import deform_columns
from .dropout import draw_keep
from .frozen_bn import frozen_bn_site
from .heads import detection_heads
from .lap import solve_lap
from .ms_deform_attn import ms_deform_attn
from .nms import nms_pack
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
    "dropout_keep_mask": draw_keep,
    "detection_heads": detection_heads,
    "deform_conv": deform_columns,
    "frozen_bn": frozen_bn_site,
    "nms": nms_pack,
    "ms_deform_attn": ms_deform_attn,
}
SERVE_KERNELS = ("pixel_align_sample", "flash_cross_attention_fwd",
                 "detection_heads")


_GRAPHS = set()            # the live graphs' GraphLaunches


class GraphLaunches:
    """The kernel launches that one replay of a captured graph makes, by
    name, and the replays since the counts were last reset: a replay adds
    one to `replays`, and `launch_counts` multiplies. `fold()` (when the
    graph is dropped) moves its launches into the wrappers' counters."""

    def __init__(self, launches: dict):
        self.launches, self.replays = dict(launches), 0
        _GRAPHS.add(self)

    def fold(self) -> None:
        for name, n in self.launches.items():
            KERNELS[name].launches += n * self.replays
        self.replays = 0
        _GRAPHS.discard(self)


def launch_counts() -> dict:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for g in list(_GRAPHS):
        for name, n in g.launches.items():
            counts[name] += n * g.replays
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for g in list(_GRAPHS):
        g.replays = 0


__all__ = ["GraphLaunches", "KERNELS", "SERVE_KERNELS", "deform_columns",
           "detection_heads", "draw_keep",
           "flash_bwd", "flash_bwd_kv",
           "flash_cross_attention_kv_fused", "flash_fwd_lse",
           "flash_fwd_lse_kv", "frozen_bn_site",
           "launch_counts", "ms_deform_attn", "nms_pack",
           "pixel_aligned_features_kernel",
           "reset_launch_counts", "sample_views", "sample_views_bwd_mem",
           "solve_lap"]

"""The decoder's dropout keep masks, drawn on the card from device seeds
(``csrc/dropout.cu``).

Not a TPU kernel: the port's counterpart of the JAX package's
`_grouped_keep` (parq_tpu/models/decoder.py:76-87), which draws on the
device from keys split and folded there. `draw_keep` draws G masks of
`rows` x `cols` with the flash kernels' v1 counter hash
(`cross_attention.keep_mask`), one int64 seed a group read from device
memory, rows numbered from `row0` (a data-parallel rank's first global
row). It launches the CUDA kernel for a CUDA seed tensor (or raises) and
runs `draw_keep_plain` for a CPU one; both give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .cross_attention import dropout_threshold, keep_mask


def draw_keep_plain(seeds: torch.Tensor, rows: int, row0: int, cols: int,
                    rate: float) -> torch.Tensor:
    """Plain version of the keep-mask kernel: seeds (G,) int64 → bool
    (rows, G, cols), True where kept: `keep_mask` of each group's seed with
    the (b·H + h) term 0, rows row0 .. row0 + rows − 1, cols 0 .. cols − 1."""
    return keep_mask(seeds.long(), 0, rows, cols, rate,
                     q0=row0).transpose(0, 1).contiguous()


def _lib():
    fn = _build.load("dropout").parq_keep_mask
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def draw_keep(seeds: torch.Tensor, rows: int, row0: int, cols: int,
              rate: float) -> torch.Tensor:
    """The keep-mask kernel. seeds (G,) int64, any stride (a column of the
    decoder's seed table) → bool (rows, G, cols), contiguous. CPU seeds take
    the plain version."""
    if seeds.device.type == "cpu":
        return draw_keep_plain(seeds, rows, row0, cols, rate)
    if seeds.dtype != torch.int64 or seeds.dim() != 1:
        raise ValueError(f"draw_keep: seeds {seeds.dtype} "
                         f"{tuple(seeds.shape)}, want (G,) int64")
    G = seeds.shape[0]
    out = torch.empty((rows, G, cols), dtype=torch.bool, device=seeds.device)
    sms = torch.cuda.get_device_properties(
        seeds.device).multi_processor_count
    err = _lib()(seeds.data_ptr(), seeds.stride(0), rows, G, cols, row0,
                 dropout_threshold(rate), out.data_ptr(), sms,
                 torch.cuda.current_stream(seeds.device).cuda_stream)
    if err:
        raise RuntimeError(f"draw_keep: CUDA launch failed, error {err}")
    draw_keep.launches += 1
    return out


draw_keep.launches = 0

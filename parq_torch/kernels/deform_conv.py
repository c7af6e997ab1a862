"""Modulated deformable convolution (DCNv2), 3x3, stride 1, padding 1, one
deform group: the bilinear im2col with the mask in a kernel
(``csrc/deform_conv.cu``), the product with the weights a GEMM.

Not a TPU kernel: the JAX package has no deformable convolution. PETR's
ResNet-50 makes the 3x3 conv of every block of stages 3 and 4 a DCNv2
(`ops.deform_conv.ModulatedDeformConv2d`); its offset conv gives 27
channels a pixel in mmcv's layout: channel 2k is dy and 2k + 1 dx of
kernel point k (row-major over the 3x3 window), channels 18..26 the mask
logits. `deform_columns` samples the input map at p + p_k + (dy_k, dx_k)
with bilinear weights (a corner tap off the map counts 0, as mmcv's
dmcn_im2col_bilinear; a point outside (-1, H) x (-1, W) samples 0),
multiplies by sigmoid(mask logit) and writes the columns (N, H, W, 9, C)
in the map's dtype, from f32 sums. `modulated_deform_conv` then takes
their product with the weights (Cout, C, 3, 3) as one matrix product, so
its output is the channels-last map the backbone continues with.

`deform_columns_plain` is the plain version: `grid_sample` per kernel point
(align_corners=True, zero padding) in f32, times the mask, cast once. For a
CUDA tensor `deform_columns` launches the kernel (or raises); for a CPU
tensor it runs the plain version. The kernel has no backward: a CUDA call
that needs a gradient raises (PETR's training is not ported).
`deform_columns.launches` counts the kernel's launches; the library is
built and loaded at the first launch, so a process whose models have no
DCN never builds it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

POINTS = 9                      # 3 x 3
OFFSET_CHANNELS = 3 * POINTS    # (dy, dx) pairs, then the mask logits


def _check(x: torch.Tensor, om: torch.Tensor) -> None:
    if x.dim() != 4 or om.dim() != 4 or om.shape[1] != OFFSET_CHANNELS \
            or om.shape[0] != x.shape[0] or om.shape[2:] != x.shape[2:]:
        raise ValueError(f"deform_columns: x {tuple(x.shape)} (N, C, H, W) "
                         f"and om {tuple(om.shape)} (N, 27, H, W)")


def deform_columns_plain(x: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel. x (N, C, H, W), om (N, 27, H, W) →
    columns (N, H, W, 9, C) in x's dtype: per kernel point k, grid_sample
    of x in f32 at (y, x) = (h - 1 + k // 3 + dy_k, w - 1 + k % 3 + dx_k)
    (align_corners=True, zero padding), times sigmoid(om[:, 18 + k])."""
    _check(x, om)
    N, C, H, W = x.shape
    xf, omf = x.float(), om.float()
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=x.device),
        torch.arange(W, dtype=torch.float32, device=x.device), indexing="ij")
    mask = torch.sigmoid(omf[:, 2 * POINTS:])
    cols = []
    for k in range(POINTS):
        y = gy + (k // 3 - 1) + omf[:, 2 * k]
        xx = gx + (k % 3 - 1) + omf[:, 2 * k + 1]
        grid = torch.stack([2.0 * xx / max(W - 1, 1) - 1.0,
                            2.0 * y / max(H - 1, 1) - 1.0], dim=-1)
        s = F.grid_sample(xf, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)                 # (N, C, H, W)
        cols.append((s * mask[:, k:k + 1]).permute(0, 2, 3, 1))
    return torch.stack(cols, dim=3).to(x.dtype)


def _lib():
    fn = _build.load("deform_conv").parq_deform_conv_im2col
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def deform_columns(x: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
    """The columns (N, H, W, 9, C) of x (N, C, H, W) at the offsets and
    mask logits om (N, 27, H, W): the kernel for CUDA tensors (bf16 or
    f32; om is cast to x's dtype), the plain version for CPU tensors."""
    _check(x, om)
    if x.device.type != "cuda":
        return deform_columns_plain(x, om)
    if torch.is_grad_enabled() and (x.requires_grad or om.requires_grad):
        raise NotImplementedError("deform_columns: the kernel has no "
                                  "backward (PETR's training is not ported)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"deform_columns: x is {x.dtype}; bf16 or f32")
    if om.device != x.device:
        raise ValueError("deform_columns: x and om on different devices")
    N, C, H, W = x.shape
    if C % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"deform_columns: C = {C} is not a multiple of 16 "
                         "bytes of the map's dtype")
    xh = x.permute(0, 2, 3, 1).contiguous()        # free for channels_last
    oh = om.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    col = torch.empty((N, H, W, POINTS, C), dtype=x.dtype, device=x.device)
    if any(t.data_ptr() % 16 for t in (xh, col)):
        raise ValueError("deform_columns: tensors must be 16-byte aligned")
    err = _lib()(xh.data_ptr(), oh.data_ptr(), col.data_ptr(), N, H, W, C,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"deform_columns: CUDA launch failed, error {err}")
    deform_columns.launches += 1
    return col


deform_columns.launches = 0


def modulated_deform_conv(x: torch.Tensor, om: torch.Tensor,
                          weight: torch.Tensor) -> torch.Tensor:
    """DCNv2 of x (N, C, H, W) with offsets and mask logits om (N, 27, H,
    W) and weight (Cout, C, 3, 3), no bias: (N, Cout, H, W), channels-last
    in memory. The columns' product with the weights runs under the
    caller's autocast (bf16 operands, f32 sums, on the card)."""
    N, C, H, W = x.shape
    cols = deform_columns(x, om).reshape(N * H * W, POINTS * C)
    w = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], POINTS * C)
    out = F.linear(cols, w)
    return out.view(N, H, W, -1).permute(0, 3, 1, 2)

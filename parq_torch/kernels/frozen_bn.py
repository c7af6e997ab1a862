"""FrozenBatchNorm2d with the residual add and the ReLU that follow it, in
one pass over a channels-last bf16 map (``csrc/frozen_bn.cu``).

Not a TPU kernel: the JAX package's ResNet body leaves its frozen affine,
ReLU and residual adds to XLA's fusions. The port's body
(`models/resnet_fpn.py`) calls `frozen_bn_site` at every BN site, in three
forms: ``relu(bn(x))`` (the stem, a block's bn1 and bn2),
``relu(bn(x) + r)`` (a block's last BN and its identity) and
``relu(bn(x) + bn_d(r))`` (the same with the downsample conv's raw output
r and its BN, which then costs no launch of its own): 49 launches a
ResNet-50 forward, every camera or view at once.

`frozen_bn_site_plain` is the plain version: the modules' own ops, as
the body ran them before (`FrozenBatchNorm2d.forward`, the add,
`F.relu`). The kernel computes the same f32 steps with the same bf16
roundings, so its output equals the plain version's bit for bit: s =
bf16(w · rsqrt(var + eps)) and t = bf16(bias − mean · w · rsqrt(var +
eps)) are derived in the kernel from the four f32 buffers (rsqrtf, which
torch.rsqrt's CUDA kernel calls), then y = bf16(bf16(x · s) + t), the
residual added and rounded, ReLU passing NaN as F.relu does.

`engages(x, residual)` is the dispatch rule: the kernel takes a call on
CUDA tensors in bf16 in channels-last memory (a DCN's permuted output
included), C a multiple of 8, 16-byte aligned, the residual alike, with
no gradient to record (grad mode off, or no map requires grad), and not
while torch.export or torch.compile traces the model (an exported program
keeps the modules' ops). Everything else (a body that trains, f32, the
CPU, contiguous NCHW maps) runs the plain version. A frozen body
(`BACKBONE2D.FREEZE`) records no gradient even in a training step, so
the kernel takes its bf16 sites there too, with the same bits.
`frozen_bn_site.launches` counts the kernel's launches
(`kernels.launch_counts()["frozen_bn"]`); the library is built and
loaded at the first.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import _build

VEC = 8                        # bf16 channels in 16 bytes


def engages(x: torch.Tensor, residual: Optional[torch.Tensor] = None
            ) -> bool:
    """Whether `frozen_bn_site` launches the kernel for this call."""
    maps = (x,) if residual is None else (x, residual)
    if torch.compiler.is_compiling():
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in maps):
        return False
    if x.dim() != 4 or x.shape[1] % VEC:
        return False
    return all(t.device.type == "cuda" and t.device == x.device
               and t.dtype == torch.bfloat16 and t.shape == x.shape
               and t.is_contiguous(memory_format=torch.channels_last)
               and t.storage_offset() % VEC == 0 for t in maps)


def frozen_bn_site_plain(x: torch.Tensor, bn: nn.Module,
                         residual: Optional[torch.Tensor] = None,
                         residual_bn: Optional[nn.Module] = None
                         ) -> torch.Tensor:
    """Plain version: bn(x), plus the residual (through residual_bn when
    one is given), then ReLU."""
    y = bn(x)
    if residual is not None:
        y = y + (residual if residual_bn is None else residual_bn(residual))
    return F.relu(y)


def _lib():
    fn = _build.load("frozen_bn").parq_frozen_bn
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        ptr, f32 = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [ptr] * 7 + [f32] + [ptr] * 4 + [f32] \
            + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def _buffers(bn: nn.Module):
    return [bn.weight.data_ptr(), bn.bias.data_ptr(),
            bn.running_mean.data_ptr(), bn.running_var.data_ptr(), bn.eps]


def frozen_bn_site(x: torch.Tensor, bn: nn.Module,
                   residual: Optional[torch.Tensor] = None,
                   residual_bn: Optional[nn.Module] = None
                   ) -> torch.Tensor:
    """relu(bn(x) + residual_bn(residual)), the residual and its BN
    optional as in `frozen_bn_site_plain`: the kernel where `engages`, else
    the plain version. bn and residual_bn are FrozenBatchNorm2d modules
    (f32 buffers weight, bias, running_mean, running_var of C channels, and
    eps)."""
    if not engages(x, residual):
        return frozen_bn_site_plain(x, bn, residual, residual_bn)
    bns = (bn,) if residual_bn is None else (bn, residual_bn)
    C = x.shape[1]
    for m in bns:
        for b in (m.weight, m.bias, m.running_mean, m.running_var):
            if b.dtype != torch.float32 or b.device != x.device \
                    or b.shape != (C,) or not b.is_contiguous():
                raise ValueError(f"frozen_bn: buffers must be f32 ({C},) "
                                 f"on {x.device}")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    maps = [x, y] if residual is None else [x, residual, y]
    if any(t.data_ptr() % 16 for t in maps):
        raise ValueError("frozen_bn: maps must be 16-byte aligned")
    res = 0 if residual is None else 1 if residual_bn is None else 2
    second = _buffers(residual_bn) if res == 2 else [None] * 4 + [0.0]
    err = _lib()(x.data_ptr(), None if residual is None
                 else residual.data_ptr(), y.data_ptr(), *_buffers(bn),
                 *second, x.numel() // C, C, res,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"frozen_bn: CUDA launch failed, error {err}")
    frozen_bn_site.launches += 1
    return y


frozen_bn_site.launches = 0

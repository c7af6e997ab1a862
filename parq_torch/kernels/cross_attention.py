"""Kernel B2 — flash cross-attention forward over the fused K/V buffer
(``csrc/cross_attention.cu``).

Replaces parq_tpu/kernels/cross_attention_pallas.py:_fwd_call in its eval
form (`flash_cross_attention_kv_fused`: no dropout, no LSE). K/V arrive as
one (B, N, H·2D) buffer whose lanes [h·2D, h·2D + D) hold K_h and
[h·2D + D, (h+1)·2D) hold V_h — the output of the decoder's single fused
projection. `flash_cross_attention_kv_fused` launches the CUDA kernel for
CUDA tensors (or raises) and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)  # head dims the CUDA kernel is built for


def split_kv(kv: torch.Tensor, heads: int):
    """Fused (B, N, H·2D) → k, v views (B, H, N, D) (strided, no copy)."""
    B, N, F = kv.shape
    kvh = kv.view(B, N, heads, 2, F // (2 * heads))
    return kvh[:, :, :, 0].transpose(1, 2), kvh[:, :, :, 1].transpose(1, 2)


def cross_attention_kv_fused_plain(q: torch.Tensor,
                                   kv: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B2: the materializing softmax in f32.
    q (B, H, Q, D), kv (B, N, H·2D) → (B, H, Q, D) in q's dtype."""
    D = q.shape[-1]
    k, v = split_kv(kv, q.shape[1])
    s = (q.float() * D ** -0.5) @ k.float().transpose(-1, -2)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _lib():
    lib = _build.load("cross_attention")
    fn = lib.parq_flash_fwd_kv_fused
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_cross_attention_kv_fused(q: torch.Tensor,
                                   kv: torch.Tensor) -> torch.Tensor:
    """Kernel B2. q (B, H, Q, D), kv (B, N, H·2D), both bf16 or both f32
    → o (B, H, Q, D) in q's dtype. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return cross_attention_kv_fused_plain(q, kv)
    B, H, Q, D = q.shape
    if kv.dim() != 3 or kv.shape[0] != B or kv.shape[2] != 2 * H * D:
        raise ValueError(f"flash: kv {tuple(kv.shape)} vs q {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or kv.dtype != q.dtype:
        raise TypeError(f"flash: dtypes q {q.dtype}, kv {kv.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash: head dim {D} not in {HEAD_DIMS}")
    if kv.device != q.device or kv.shape[1] < 1:
        raise ValueError("flash: kv must be non-empty and on q's device")
    q, kv = q.contiguous(), kv.contiguous()
    o = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, kv, o)):
        raise ValueError("flash: inputs must be 16-byte aligned")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), kv.data_ptr(), o.data_ptr(), B, H, Q,
                 kv.shape[1], D, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash: CUDA launch failed, error {err}")
    flash_cross_attention_kv_fused.launches += 1
    return o


flash_cross_attention_kv_fused.launches = 0

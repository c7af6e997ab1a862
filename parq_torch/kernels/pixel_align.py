"""Kernel B1 — pixel-aligned sampler forward (``csrc/pixel_align.cu``).

Replaces parq_tpu/kernels/pixel_align_pallas.py:_pallas_sample. The
projection to ``(u, v, scale)`` stays plain torch outside the kernel, as
``_project_uvs`` does in JAX; the kernel gathers the bilinear taps of every
view, scales and sums them. `sample_views` launches the CUDA kernel for a
CUDA tensor (or raises) and runs `sample_views_plain` for a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..geometry import Camera, Pose
from ..ops.grid_sample import sample_bilinear_pixels
from . import _build


def project_uvs(query_pos: torch.Tensor, T_camera_local: Pose,
                camera: Camera):
    """Projection + valid-mean scale: uvs (B, T, Q, 4) rows
    ``[u, v, 1/max(valid count, 1), 0]`` (the scale is the same for every
    view of a query), plus center_im (B, T, Q, 2) and center_valid."""
    query_pos_c = T_camera_local.transform(query_pos[:, None, :, :])
    center_im, center_valid = camera.project(query_pos_c)
    count = center_valid.float().sum(dim=1).clamp(min=1.0)     # (B, Q)
    scale = (1.0 / count)[:, None, :].expand(center_valid.shape)
    uvs = torch.cat([center_im, scale[..., None],
                     torch.zeros_like(scale[..., None])], dim=-1)
    return uvs.float().contiguous(), center_im, center_valid


def sample_views_plain(memory: torch.Tensor, uvs: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of kernel B1: memory (B, T, H, W, C), uvs
    (B, T, Q, 4) → (B, Q, C) float32."""
    B, T, H, W, C = memory.shape
    Q = uvs.shape[2]
    feats = sample_bilinear_pixels(memory.reshape(B * T, H, W, C),
                                   uvs[..., :2].reshape(B * T, Q, 2))
    return (feats.reshape(B, T, Q, C) * uvs[..., 2:3]).sum(dim=1)


def _lib():
    lib = _build.load("pixel_align")
    fn = lib.parq_sample_views
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sample_views(memory: torch.Tensor, uvs: torch.Tensor) -> torch.Tensor:
    """Kernel B1. memory (B, T, H, W, C) bf16 or f32, uvs (B, T, Q, 4) f32
    → (B, Q, C) f32. CPU tensors take the plain version."""
    if memory.device.type == "cpu":
        return sample_views_plain(memory, uvs)
    B, T, H, W, C = memory.shape
    Q = uvs.shape[2]
    if memory.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sample_views: memory dtype {memory.dtype}")
    if uvs.dtype != torch.float32 or tuple(uvs.shape) != (B, T, Q, 4):
        raise ValueError(f"sample_views: uvs {uvs.dtype} {tuple(uvs.shape)}")
    if uvs.device != memory.device:
        raise ValueError("sample_views: memory and uvs on different devices")
    if C % 8 or not memory.is_contiguous() or not uvs.is_contiguous():
        raise ValueError("sample_views: needs contiguous inputs and C % 8 == 0")
    out = torch.empty((B, Q, C), dtype=torch.float32, device=memory.device)
    if any(t.data_ptr() % 16 for t in (memory, uvs, out)):
        raise ValueError("sample_views: inputs must be 16-byte aligned")
    stream = torch.cuda.current_stream(memory.device).cuda_stream
    err = _lib()(memory.data_ptr(), uvs.data_ptr(), out.data_ptr(),
                 B, T, H, W, C, Q, int(memory.dtype == torch.bfloat16),
                 stream)
    if err:
        raise RuntimeError(f"sample_views: CUDA launch failed, error {err}")
    sample_views.launches += 1
    return out


sample_views.launches = 0


def pixel_aligned_features_kernel(
    memory_hw: torch.Tensor,
    query_pos: torch.Tensor,
    T_camera_local: Pose,
    camera: Camera,
    feat_size: Tuple[int, int],
):
    """Same contract as ops.pixel_align.pixel_aligned_features, through
    kernel B1; features come back in the memory's dtype."""
    B, T, H, W, C = memory_hw.shape
    if tuple(feat_size) != (W, H):
        raise ValueError(f"feat_size {feat_size} != memory {(W, H)}")
    uvs, center_im, center_valid = project_uvs(query_pos, T_camera_local,
                                               camera)
    feats = sample_views(memory_hw.contiguous(), uvs)
    return feats.to(memory_hw.dtype), center_im, center_valid

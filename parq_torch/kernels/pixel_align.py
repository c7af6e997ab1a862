"""Kernels B1 and B4 — the pixel-aligned sampler, forward
(``csrc/pixel_align.cu``) and d(memory) (``csrc/pixel_align_bwd.cu``).

B1 replaces parq_tpu/kernels/pixel_align_pallas.py:_pallas_sample, B4
its _pallas_sample_bwd_mem. The projection to ``(u, v, scale)`` stays plain
torch outside the kernels, as ``_project_uvs`` does in JAX; B1 gathers the
bilinear taps of every view, scales and sums them, and B4 is its transpose
onto the memory: every output pixel gathers the cotangent rows whose taps
land on it and is written once. Each wrapper (`sample_views`,
`sample_views_bwd_mem`) launches its CUDA kernel for a CUDA tensor (or
raises) and runs its plain version for a CPU tensor. B1 is the custom op
``parq::sample_views`` (a CUDA implementation that launches the kernel, a
CPU one that is the plain version, a fake one for shapes), so an exported
program (`parq_torch.export`) launches it as the live model does. B1
returns the memory's dtype (f32 sums rounded once at the store; JAX's
kernel writes f32 and its caller casts), so in training the cotangent
reaches B4 in that dtype and B4's wrapper casts nothing.

The training entries mirror the JAX package's custom VJPs:
`pixel_aligned_features_train` (forward B1, backward B4;
`_sample_op_fast`) and `pixel_aligned_features_precomputed` (forward
returns saved features, backward B4; `_sample_op_pre`). Their d(uvs) comes
from torch autograd of `sample_views_plain` with the memory held fixed, on
the first `diff_rows` query rows only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
    """Plain version of kernel B1's sums: memory (B, T, H, W, C), uvs
    (B, T, Q, 4) → (B, Q, C) float32 (`sample_views` on the CPU casts them
    to the memory's dtype)."""
    B, T, H, W, C = memory.shape
    Q = uvs.shape[2]
    feats = sample_bilinear_pixels(memory.reshape(B * T, H, W, C),
                                   uvs[..., :2].reshape(B * T, Q, 2))
    return (feats.reshape(B, T, Q, C) * uvs[..., 2:3]).sum(dim=1)


def _lib():
    lib = _build.load("pixel_align")
    fn = lib.parq_sample_views
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sample_views(memory: torch.Tensor, uvs: torch.Tensor) -> torch.Tensor:
    """Kernel B1. memory (B, T, H, W, C) bf16 or f32, uvs (B, T, Q, 4) f32
    → (B, Q, C) in the memory's dtype: f32 sums, rounded to bf16 (to
    nearest even) once at the store for a bf16 memory, the same bits as
    `sample_views_sums(...).to(torch.bfloat16)`. CPU tensors take the
    plain version, cast the same way. It runs through the custom op
    ``parq::sample_views``, so `torch.export` keeps the launch in an
    exported program."""
    return torch.ops.parq.sample_views(memory, uvs)


def sample_views_sums(memory: torch.Tensor, uvs: torch.Tensor
                      ) -> torch.Tensor:
    """Kernel B1 with its f32 sums written before any rounding: (B, Q, C)
    f32 whatever the memory's dtype. What checks hold against the plain
    version and across versions of the kernel; the model's path calls
    `sample_views`. CPU tensors take the plain version."""
    if memory.device.type == "cpu":
        return sample_views_plain(memory, uvs)
    return _sample_views_launch(memory, uvs, torch.float32)


@torch.library.custom_op("parq::sample_views", mutates_args=())
def _sample_views_op(memory: torch.Tensor, uvs: torch.Tensor
                     ) -> torch.Tensor:
    return sample_views_plain(memory, uvs).to(memory.dtype)


@_sample_views_op.register_fake
def _(memory, uvs):
    B, T, H, W, C = memory.shape
    return memory.new_empty((B, uvs.shape[2], C))


@_sample_views_op.register_kernel("cuda")
def _sample_views_cuda(memory: torch.Tensor, uvs: torch.Tensor
                       ) -> torch.Tensor:
    return _sample_views_launch(memory, uvs, memory.dtype)


def _sample_views_launch(memory: torch.Tensor, uvs: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
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
    out = torch.empty((B, Q, C), dtype=out_dtype, device=memory.device)
    if any(t.data_ptr() % 16 for t in (memory, uvs, out)):
        raise ValueError("sample_views: inputs must be 16-byte aligned")
    stream = torch.cuda.current_stream(memory.device).cuda_stream
    err = _lib()(memory.data_ptr(), uvs.data_ptr(), out.data_ptr(),
                 B, T, H, W, C, Q, int(memory.dtype == torch.bfloat16),
                 int(out_dtype != memory.dtype), stream)
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
    return feats, center_im, center_valid


def sample_views_bwd_mem_plain(uvs: torch.Tensor, g: torch.Tensor,
                               mem_shape, dtype) -> torch.Tensor:
    """Plain version of kernel B4: uvs (B, T, Q, 4), g (B, Q, C) →
    d(memory) (B, T, H, W, C) in `dtype`. g is rounded to `dtype` first, as
    the kernel's caller does; the sums are f32 (index_add_)."""
    B, T, H, W, C = mem_shape
    Q = uvs.shape[2]
    gq = g.to(dtype).float()[:, None].expand(B, T, Q, C)
    x0, y0 = torch.floor(uvs[..., 0]), torch.floor(uvs[..., 1])
    wx1, wy1 = uvs[..., 0] - x0, uvs[..., 1] - y0
    bt = torch.arange(B * T, device=uvs.device).view(B, T, 1)
    out = torch.zeros(B * T * H * W, C, dtype=torch.float32,
                      device=uvs.device)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            x, y = x0 + dx, y0 + dy
            inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
            idx = (bt * H + y.clamp(0, H - 1).long()) * W \
                + x.clamp(0, W - 1).long()
            w = (wx * wy * uvs[..., 2]) * inb
            out.index_add_(0, idx.reshape(-1),
                           (gq * w[..., None]).reshape(-1, C))
    return out.view(B, T, H, W, C).to(dtype)


def _lib_bwd():
    lib = _build.load("pixel_align_bwd")
    fn = lib.parq_sample_views_bwd_mem
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sample_views_bwd_mem(uvs: torch.Tensor, g: torch.Tensor, mem_shape,
                         dtype) -> torch.Tensor:
    """Kernel B4. uvs (B, T, Q, 4) f32, g (B, Q, C) → d(memory)
    (B, T, H, W, C) in `dtype` (bf16 or f32). g is cast to `dtype` before
    the kernel, as JAX does; the kernel sums each pixel's taps in f32
    registers in q order and writes every pixel once in `dtype`, so the
    result needs no zeroing and is the same bit for bit from run to run.
    CPU tensors take the plain version."""
    if uvs.device.type == "cpu":
        return sample_views_bwd_mem_plain(uvs, g, mem_shape, dtype)
    B, T, H, W, C = mem_shape
    Q = uvs.shape[2]
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sample_views_bwd_mem: memory dtype {dtype}")
    if uvs.dtype != torch.float32 or tuple(uvs.shape) != (B, T, Q, 4):
        raise ValueError(f"sample_views_bwd_mem: uvs {uvs.dtype} "
                         f"{tuple(uvs.shape)}")
    if tuple(g.shape) != (B, Q, C) or g.device != uvs.device:
        raise ValueError(f"sample_views_bwd_mem: g {tuple(g.shape)} on "
                         f"{g.device}")
    if C % 8:
        raise ValueError("sample_views_bwd_mem: needs C % 8 == 0")
    uvs, g = uvs.contiguous(), g.to(dtype).contiguous()
    dmem = torch.empty(mem_shape, dtype=dtype, device=uvs.device)
    if any(t.data_ptr() % 16 for t in (uvs, g, dmem)):
        raise ValueError("sample_views_bwd_mem: inputs must be 16-byte "
                         "aligned")
    stream = torch.cuda.current_stream(uvs.device).cuda_stream
    err = _lib_bwd()(uvs.data_ptr(), g.data_ptr(), dmem.data_ptr(), B, T, H,
                     W, C, Q, int(dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"sample_views_bwd_mem: CUDA launch failed, "
                           f"error {err}")
    sample_views_bwd_mem.launches += 1
    return dmem


sample_views_bwd_mem.launches = 0


def _sampler_backward(memory, uvs, g, diff_rows):
    """(d memory by B4, d uvs by autograd of the plain gather on the first
    `diff_rows` rows, the memory held fixed)."""
    dmem = sample_views_bwd_mem(uvs, g, memory.shape, memory.dtype)
    R = uvs.shape[2] if diff_rows is None else min(diff_rows, uvs.shape[2])
    duvs = torch.zeros_like(uvs)
    with torch.enable_grad():
        u = uvs[:, :, :R].detach().requires_grad_(True)
        out = sample_views_plain(memory.detach(), u)
        duvs[:, :, :R], = torch.autograd.grad(out, u, g[:, :R].float())
    return dmem, duvs


class _SampleTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, memory, uvs, diff_rows):
        ctx.save_for_backward(memory, uvs)
        ctx.diff_rows = diff_rows
        return sample_views(memory, uvs)

    @staticmethod
    def backward(ctx, g):
        memory, uvs = ctx.saved_tensors
        dmem, duvs = _sampler_backward(memory, uvs, g, ctx.diff_rows)
        return dmem, duvs, None


class _SamplePrecomputed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, memory, uvs, feats, diff_rows):
        ctx.save_for_backward(memory, uvs)
        ctx.diff_rows = diff_rows
        return feats.clone()

    @staticmethod
    def backward(ctx, g):
        memory, uvs = ctx.saved_tensors
        dmem, duvs = _sampler_backward(memory, uvs, g, ctx.diff_rows)
        return dmem, duvs, None, None


def pixel_aligned_features_train(
    memory_hw: torch.Tensor,
    query_pos: torch.Tensor,
    T_camera_local: Pose,
    camera: Camera,
    feat_size: Tuple[int, int],
    diff_rows: Optional[int] = None,
):
    """`pixel_aligned_features_kernel` with a gradient: forward B1,
    backward B4 for d(memory) and autograd for d(query_pos)."""
    uvs, center_im, center_valid = project_uvs(query_pos, T_camera_local,
                                               camera)
    feats = _SampleTrain.apply(memory_hw.contiguous(), uvs, diff_rows)
    return feats, center_im, center_valid


def pixel_aligned_features_precomputed(
    memory_hw: torch.Tensor,
    query_pos: torch.Tensor,
    T_camera_local: Pose,
    camera: Camera,
    feat_size: Tuple[int, int],
    feats_pre: torch.Tensor,
    diff_rows: Optional[int] = None,
):
    """The sampler with its forward skipped: `feats_pre` is the (B, Q, C)
    output of an identical earlier call. The projection reruns (cheap; it
    keeps the query-coordinate gradient exact) and the backward is B4 plus
    the coordinate VJP on the first `diff_rows` rows."""
    uvs, center_im, center_valid = project_uvs(query_pos, T_camera_local,
                                               camera)
    feats = _SamplePrecomputed.apply(memory_hw.contiguous(), uvs,
                                     feats_pre.detach().to(memory_hw.dtype),
                                     diff_rows)
    return feats, center_im, center_valid

"""Multi-scale deformable attention (MSDA), the forward of mmcv's
MultiScaleDeformableAttnFunction with the softmax of the attention
logits, the sampling locations and the combination of several value
frames folded in (``csrc/ms_deform_attn.cu``).

Not a TPU kernel: the JAX package has no deformable attention (B1,
``csrc/pixel_align.cu``, one tap a view, is the port's nearest gather).
BEVFormer (`models/bevformer.py`) calls it at three sites a layer:

- spatial cross-attention: 6 camera frames of 4 FPN levels, 40,000 BEV
  queries, 4 height anchors a query per camera, 8 points a level (point
  p at anchor p % 4); a query takes the cameras its `hit` row names and
  their sum over the count (at least 1);
- temporal self-attention: 2 frames (the previous and the current BEV)
  of one 200 x 200 level, 4 points, each frame with its own offsets and
  logits (G = 2), the mean of the two;
- the decoder's cross-attention: 1 frame (the BEV), 900 queries, 4
  points.

For frame f (of F), query q and head h, with g = f where the offsets
come in F groups (else 0), the softmax of logits[b, q, h, g] over its
L · P entries weights the samples

    loc = ref[b, f or 0, q, p % A] + offsets[b, q, h, g, l, p] / (w_l, h_l)
    pixel = loc · (w_l, h_l) − 0.5

bilinear in the head's 32 channels of level l of value[b, f] (mmcv's
ms_deform_attn_im2col_bilinear: a point outside (−1, h_l) x (−1, w_l)
samples 0, and each corner tap off the map counts 0). The sums are f32;
the output row (B, Q, H · 32) is the frames' combination, written once
in the value's dtype.

`ms_deform_attn_plain` is the plain version: mmcv's
`multi_scale_deformable_attn_pytorch` (one `grid_sample` a level,
bilinear, align_corners=False, zero padding) for every frame, with the
softmax weights, then the combination, in f32, cast once. For a CUDA
tensor `ms_deform_attn` launches the kernel (or raises); for a CPU tensor
it runs the plain version. The kernel has no backward (BEVFormer's
training is not ported). `ms_deform_attn.launches` counts the kernel's
launches; the library is built and loaded at the first launch, so a
process whose models have no deformable attention never builds it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIM = 32                   # the kernel's head width
MAX_LEVELS = 4
MAX_FRAMES = 8


def _check(value, shapes, ref, offsets, logits, hit):
    if value.dim() != 5 or ref.dim() != 5 or offsets.dim() != 7 \
            or logits.dim() != 5:
        raise ValueError("ms_deform_attn: value (B, F, Nv, H, d), ref (B, "
                         "Fr, Q, A, 2), offsets (B, Q, H, G, L, P, 2), "
                         "logits (B, Q, H, G, L·P)")
    B, Fn, Nv, Hh, _ = value.shape
    _, Q, _, G, L, P, _ = offsets.shape
    if sum(h * w for h, w in shapes) != Nv or len(shapes) != L:
        raise ValueError(f"ms_deform_attn: {L} levels {list(shapes)} for "
                         f"{Nv} value rows")
    if ref.shape[0] != B or ref.shape[1] not in (1, Fn) \
            or ref.shape[2] != Q or ref.shape[4] != 2 or P % ref.shape[3]:
        raise ValueError(f"ms_deform_attn: ref {tuple(ref.shape)}")
    if G not in (1, Fn) or tuple(logits.shape) != (B, Q, Hh, G, L * P) \
            or tuple(offsets.shape[:3]) != (B, Q, Hh):
        raise ValueError(f"ms_deform_attn: offsets {tuple(offsets.shape)}, "
                         f"logits {tuple(logits.shape)}")
    if hit is not None and tuple(hit.shape) != (B, Fn, Q):
        raise ValueError(f"ms_deform_attn: hit {tuple(hit.shape)} is not "
                         f"(B, F, Q) = {(B, Fn, Q)}")


def _sample_frame(value, shapes, loc, weights):
    """mmcv's multi_scale_deformable_attn_pytorch: value (B, Nv, H, d),
    loc (B, Q, H, L, P, 2), weights (B, Q, H, L, P) → (B, Q, H · d)."""
    B, _, Hh, d = value.shape
    _, Q, _, L, P, _ = loc.shape
    vals = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    out = []
    for l, (h, w) in enumerate(shapes):
        v = vals[l].flatten(2).transpose(1, 2).reshape(B * Hh, d, h, w)
        g = grids[:, :, :, l].transpose(1, 2).flatten(0, 1)
        out.append(F.grid_sample(v, g, mode="bilinear",
                                 padding_mode="zeros", align_corners=False))
    a = weights.transpose(1, 2).reshape(B * Hh, 1, Q, L * P)
    o = (torch.stack(out, dim=-2).flatten(-2) * a).sum(-1)
    return o.view(B, Hh * d, Q).transpose(1, 2)


def normaliser(shapes: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """(L, 2): each level's (w, h), the offsets' divisor."""
    s = torch.tensor(list(shapes), dtype=torch.float32, device=device)
    return torch.stack([s[:, 1], s[:, 0]], -1)


def ms_deform_attn_plain(value: torch.Tensor, shapes, ref: torch.Tensor,
                         offsets: torch.Tensor, logits: torch.Tensor,
                         hit: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of the kernel (see the module's docstring): (B, Q,
    H · d) in value's dtype."""
    _check(value, shapes, ref, offsets, logits, hit)
    B, Fn, Nv, Hh, d = value.shape
    _, Q, _, G, L, P, _ = offsets.shape
    A = ref.shape[3]
    wts = logits.float().softmax(-1).view(B, Q, Hh, G, L, P)
    off = offsets.float() / normaliser(shapes, value.device)[:, None, :]
    anchor = torch.arange(P, device=value.device) % A
    outs = []
    for f in range(Fn):
        g = f if G > 1 else 0
        r = ref[:, f if ref.shape[1] > 1 else 0].float()[:, :, anchor]
        loc = r[:, :, None, None] + off[:, :, :, g]        # (B,Q,H,L,P,2)
        outs.append(_sample_frame(value[:, f].float(), shapes, loc,
                                  wts[:, :, :, g]))
    o = torch.stack(outs, 1)                               # (B, F, Q, C)
    if hit is None:
        out = o.mean(1)
    else:
        h = hit.bool()[..., None]
        out = torch.where(h, o, torch.zeros_like(o)).sum(1) \
            / h.sum(1).clamp(min=1)
    return out.to(value.dtype)


def _lib():
    fn = _build.load("ms_deform_attn").parq_ms_deform_attn
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
            + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ms_deform_attn(value: torch.Tensor, shapes, ref: torch.Tensor,
                   offsets: torch.Tensor, logits: torch.Tensor,
                   hit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSDA of value (B, F, Nv, H, 32) over the levels `shapes` [(h, w)]
    at ref (B, Fr, Q, A, 2) float32 plus offsets (B, Q, H, G, L, P, 2)
    in cells, weighted by softmax(logits (B, Q, H, G, L · P)); frames
    combined by `hit` (B, F, Q) (sum over the count) or, without it, by
    their mean → (B, Q, H · 32) in value's dtype. The kernel for CUDA
    tensors (value bf16 or f32; offsets and logits are cast to it), the
    plain version for CPU tensors."""
    _check(value, shapes, ref, offsets, logits, hit)
    if value.device.type != "cuda":
        return ms_deform_attn_plain(value, shapes, ref, offsets, logits, hit)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, ref, offsets, logits)):
        raise NotImplementedError("ms_deform_attn: the kernel has no "
                                  "backward (BEVFormer's training is not "
                                  "ported)")
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ms_deform_attn: value is {value.dtype}; bf16 or "
                        "f32")
    B, Fn, Nv, Hh, d = value.shape
    _, Q, _, G, L, P, _ = offsets.shape
    if d != HEAD_DIM or L > MAX_LEVELS or Fn > MAX_FRAMES or G > 2:
        raise ValueError(f"ms_deform_attn: head dim {d} (the kernel takes "
                         f"{HEAD_DIM}), {L} levels (at most {MAX_LEVELS}), "
                         f"{Fn} frames (at most {MAX_FRAMES}), {G} offset "
                         "groups (at most 2)")
    if any(t.device != value.device for t in (ref, offsets, logits)) or \
            (hit is not None and hit.device != value.device):
        raise ValueError("ms_deform_attn: tensors on different devices")
    v = value.contiguous()
    r = ref.float().contiguous()
    o = offsets.to(value.dtype).contiguous()
    lg = logits.to(value.dtype).contiguous()
    h = None if hit is None else hit.to(torch.uint8).contiguous()
    out = torch.empty((B, Q, Hh * d), dtype=value.dtype, device=value.device)
    if any(t.data_ptr() % 16 for t in (v, out)):
        raise ValueError("ms_deform_attn: value and output must be 16-byte "
                         "aligned")
    lv = (ctypes.c_int * (3 * MAX_LEVELS))()
    start = 0
    for i, (hh, ww) in enumerate(shapes):
        lv[i], lv[MAX_LEVELS + i], lv[2 * MAX_LEVELS + i] = hh, ww, start
        start += hh * ww
    err = _lib()(v.data_ptr(), r.data_ptr(), o.data_ptr(), lg.data_ptr(),
                 0 if h is None else h.data_ptr(), out.data_ptr(),
                 B, Fn, Nv, Hh, r.shape[1], Q, r.shape[3], G, L, P, lv,
                 int(value.dtype == torch.bfloat16),
                 torch.cuda.current_stream(value.device).cuda_stream)
    if err:
        raise RuntimeError(f"ms_deform_attn: CUDA launch failed, error {err}")
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0

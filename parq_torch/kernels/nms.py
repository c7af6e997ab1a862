"""parse_pred's greedy 3D NMS and the pack of its detections, in one launch
(``csrc/nms.cu``).

Not a Pallas kernel: the counterpart of the JAX package's plain device
pass `nms_mask_device` (parq_tpu/evals/nms.py). `nms_pack` takes the
device half's arrays of a batch (`evals.parse_pred.parse_pred_device`),
runs the class-agnostic (or same-class) greedy NMS of each sample over
the axis-aligned bounds of its local corners, in the host library's f64
arithmetic (`native.nms3d`), and writes everything the host reads into
one f32 buffer (B, K, C), so that the host makes one copy:

    obb_data (19) | corners_local (24) | corners_world (24) | score |
    sem_cls_prob (S) | label | valid | pred_mask

with S the classes with background and C = 71 + S; label, valid and
pred_mask (kept and valid) as exact small floats. `unpack` turns the
copied buffer into parse_pred's host arrays. `nms_pack` launches the CUDA
kernel for CUDA tensors with K ≤ 1024 (or raises) and runs
`nms_pack_plain` for CPU ones, whose keep mask is the host library's
(`evals.nms.run_nms`, `native.nms3d`); the kernel gives it bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import _build

MAX_K = 1024             # csrc/nms.cu: one word of the kept set a lane
FIXED_COLUMNS = 71       # every column of the pack but the classes
OBB, LOCAL, WORLD, SCORE, PROBS = 0, 19, 43, 67, 68


def nms_pack_plain(obb_data, corners_local, corners_world, scores,
                   sem_cls_prob, labels, valid, num_semcls: int,
                   thresh: float, same_class: bool, nms: bool
                   ) -> torch.Tensor:
    """Plain version of the kernel: the same (B, K, 71 + S) f32 pack, the
    keep mask the host library's (`evals.nms.run_nms`)."""
    from ..evals.nms import run_nms     # evals imports this module
    B, K = scores.shape
    keep = (torch.from_numpy(run_nms(
        corners_local.numpy(), labels.numpy(), scores.numpy(), num_semcls,
        thresh, "nms_3d_faster_samecls" if same_class else "nms_3d_faster"))
        if nms else torch.ones_like(valid))
    return torch.cat([
        obb_data.float(), corners_local.float().reshape(B, K, 24),
        corners_world.float().reshape(B, K, 24), scores.float()[..., None],
        sem_cls_prob.float(), labels.float()[..., None],
        valid.float()[..., None], (keep & valid).float()[..., None]], dim=-1)


def unpack(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """The copied (B, K, 71 + S) pack → parse_pred's host arrays: f32 views
    of it, labels int64, valid and pred_mask bool."""
    B, K, C = packed.shape
    S = C - FIXED_COLUMNS
    return {"obb_data": packed[..., OBB:LOCAL],
            "corners_local": packed[..., LOCAL:WORLD].reshape(B, K, 8, 3),
            "corners_world": packed[..., WORLD:SCORE].reshape(B, K, 8, 3),
            "scores": packed[..., SCORE],
            "sem_cls_prob": packed[..., PROBS:PROBS + S],
            "labels": packed[..., PROBS + S].astype(np.int64),
            "valid": packed[..., PROBS + S + 1] != 0,
            "pred_mask": packed[..., PROBS + S + 2] != 0}


def _lib():
    fn = _build.load("nms").parq_nms_pack
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_double, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nms_pack(obb_data: torch.Tensor, corners_local: torch.Tensor,
             corners_world: torch.Tensor, scores: torch.Tensor,
             sem_cls_prob: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor, num_semcls: int, thresh: float,
             same_class: bool, nms: bool = True) -> torch.Tensor:
    """The NMS-and-pack kernel. obb_data (B, K, 19), corners_local and
    corners_world (B, K, 8, 3), scores (B, K), sem_cls_prob (B, K, S) f32;
    labels (B, K) int64; valid (B, K) bool; one device → (B, K, 71 + S)
    f32. With `nms` False no box is suppressed (pred_mask = valid). CPU
    tensors take the plain version."""
    args = (obb_data, corners_local, corners_world, scores, sem_cls_prob,
            labels, valid)
    if scores.device.type == "cpu":
        return nms_pack_plain(*args, num_semcls, thresh, same_class, nms)
    if scores.device.type != "cuda":
        raise ValueError(f"nms_pack: no kernel for {scores.device}")
    B, K = scores.shape
    S = sem_cls_prob.shape[-1]
    shapes = ((B, K, 19), (B, K, 8, 3), (B, K, 8, 3), (B, K), (B, K, S),
              (B, K), (B, K))
    dtypes = (torch.float32,) * 5 + (torch.int64, torch.bool)
    for t, shape, dtype in zip(args, shapes, dtypes):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != scores.device:
            raise ValueError(f"nms_pack: got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, want {dtype} {shape} on "
                             f"{scores.device}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"nms_pack: {K} boxes a sample; the kernel takes "
                         f"1 to {MAX_K}")
    out = torch.empty((B, K, FIXED_COLUMNS + S), dtype=torch.float32,
                      device=scores.device)
    if B == 0:
        return out
    args = tuple(t.contiguous() for t in args)
    err = _lib()(*(t.data_ptr() for t in args), B, K, S, num_semcls,
                 float(thresh), int(same_class), int(nms), out.data_ptr(),
                 torch.cuda.current_stream(scores.device).cuda_stream)
    if err:
        raise RuntimeError(f"nms_pack: CUDA launch failed, error {err}")
    nms_pack.launches += 1
    return out


nms_pack.launches = 0

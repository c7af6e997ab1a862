"""Prediction parsing: last-iteration outputs → filtered oriented boxes
(port of parq_tpu/evals/parse_pred.py). Rotation decode, corners and the
track-scale filter run on the outputs' device; the greedy NMS runs on the
host."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..geometry import Obb3D, Pose, rotation_matrix_from_ortho6d
from .nms import run_nms


def parse_pred_device(last_out: Dict[str, torch.Tensor],
                      T_world_local: torch.Tensor,
                      track_scale: Sequence[float]) -> Dict[str, torch.Tensor]:
    """last_out: final-iteration outputs (B, K, ...). Returns obb_data
    (B, K, 19), corners_local / corners_world (B, K, 8, 3), scores, labels,
    valid (inside the track scale's x and z bounds), sem_cls_prob."""
    size = last_out["size_unnormalized"].float()
    center = last_out["center_unnormalized"].float()
    probs = last_out["sem_cls_prob"].float()
    scores, labels = probs.amax(dim=-1), probs.argmax(dim=-1)
    B, K = scores.shape
    R = rotation_matrix_from_ortho6d(
        last_out["ortho6d"].float().reshape(B * K, 6)).reshape(B, K, 3, 3)
    T_local_object = Pose.from_Rt(R, center)
    half = size / 2.0
    c3o = torch.stack([-half[..., 0], half[..., 0], -half[..., 1],
                       half[..., 1], -half[..., 2], half[..., 2]], dim=-1)
    obbs = Obb3D.from_parts(c3o, T_local_object.data, labels.float())
    corners_local = T_local_object.transform(obbs.corners_object)
    Twl = T_world_local
    if Twl.dim() == 3:
        Twl = Twl[:, 0, :]
    corners_world = Pose(Twl[:, None, :]).transform(corners_local)
    ts = track_scale
    valid = ((center[..., 0] > ts[0]) & (center[..., 0] < ts[1])
             & (center[..., 2] > ts[4]) & (center[..., 2] < ts[5]))
    return {"obb_data": obbs.data, "corners_local": corners_local,
            "corners_world": corners_world, "scores": scores,
            "labels": labels, "valid": valid, "sem_cls_prob": probs}


def parse_pred(last_out: Dict[str, torch.Tensor],
               T_world_local: torch.Tensor, track_scale: Sequence[float],
               num_semcls: int) -> Dict[str, np.ndarray]:
    """Device parse + host NMS (class-agnostic, overlap 0.1, in the local
    frame, as configs/eval.yaml's ENABLE_NMS) → numpy dict with
    ``pred_mask`` = kept by NMS and inside the track scale."""
    dev = parse_pred_device(last_out, T_world_local, track_scale)
    host = {k: v.cpu().numpy() for k, v in dev.items()}
    keep = run_nms(host["corners_local"], host["labels"], host["scores"],
                   num_semcls, 0.1)
    host["pred_mask"] = keep & host["valid"]
    return host

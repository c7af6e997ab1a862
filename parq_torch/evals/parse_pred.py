"""Prediction parsing: last-iteration outputs → filtered oriented boxes
(port of parq_tpu/evals/parse_pred.py). Rotation decode, corners and the
track-scale filter run on the outputs' device (`parse_pred_device`); the
host half (`finish_parse_pred`) copies them to numpy and runs the greedy
NMS, so an eval loop can launch the next batch before it."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..geometry import Obb3D, Pose, rotation_matrix_from_ortho6d
from .nms import run_nms


def parse_pred_device(last_out: Dict[str, torch.Tensor],
                      T_world_local: torch.Tensor,
                      track_scale: Sequence[float],
                      for_vis: bool = False) -> Dict[str, torch.Tensor]:
    """last_out: final-iteration outputs (B, K, ...). Returns obb_data
    (B, K, 19), corners_local / corners_world (B, K, 8, 3), scores, labels,
    valid (inside the track scale's x and z bounds; everything when
    `for_vis`), sem_cls_prob."""
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
    if for_vis:
        valid = torch.ones((B, K), dtype=torch.bool, device=center.device)
    else:
        ts = track_scale
        valid = ((center[..., 0] > ts[0]) & (center[..., 0] < ts[1])
                 & (center[..., 2] > ts[4]) & (center[..., 2] < ts[5]))
    return {"obb_data": obbs.data, "corners_local": corners_local,
            "corners_world": corners_world, "scores": scores,
            "labels": labels, "valid": valid, "sem_cls_prob": probs}


def finish_parse_pred(dev: Dict[str, torch.Tensor], num_semcls: int,
                      enable_nms: bool = True, for_vis: bool = False
                      ) -> Dict[str, np.ndarray]:
    """Host half: the device arrays to numpy, then the greedy NMS in the
    local frame on the reference's thresholds: 0.1 class-agnostic for
    eval, 0.2 same-class for vis. ``pred_mask`` = kept and valid."""
    host = {k: v.cpu().numpy() for k, v in dev.items()}
    if enable_nms:
        if for_vis:
            keep = run_nms(host["corners_local"], host["labels"],
                           host["scores"], num_semcls, 0.2,
                           "nms_3d_faster_samecls")
        else:
            keep = run_nms(host["corners_local"], host["labels"],
                           host["scores"], num_semcls, 0.1, "nms_3d_faster")
        host["pred_mask"] = keep & host["valid"]
    else:
        host["pred_mask"] = host["valid"]
    host["pred_corners_world"] = host["corners_world"]
    return host


def parse_pred(last_out: Dict[str, torch.Tensor],
               T_world_local: torch.Tensor, track_scale: Sequence[float],
               num_semcls: int, enable_nms: bool = True,
               for_vis: bool = False) -> Dict[str, np.ndarray]:
    """Device parse + host NMS → numpy dict ready for F1Calculator.step."""
    dev = parse_pred_device(last_out, T_world_local, track_scale, for_vis)
    return finish_parse_pred(dev, num_semcls, enable_nms, for_vis)


def targets_to_gt_list(targets) -> List[Dict[str, np.ndarray]]:
    """Masked Targets → per-sample host GT dicts for F1Calculator.step."""
    valid = targets.valid.cpu().numpy()
    labels = targets.labels.cpu().numpy()
    corners = targets.corners_world.cpu().numpy()
    out = []
    for b in range(valid.shape[0]):
        idx = np.where(valid[b])[0]
        out.append({"labels": labels[b, idx],
                    "gt_corners_world": corners[b, idx]})
    return out

"""Prediction parsing: last-iteration outputs → filtered oriented boxes
(port of parq_tpu/evals/parse_pred.py). Rotation decode, corners and the
track-scale filter run on the outputs' device (`parse_pred_device`); the
host half (`finish_parse_pred`) brings the detections to numpy, so an
eval loop can launch the next batch before it. On the card the device
half also runs the greedy NMS and packs every array the host reads into
one buffer (`kernels.nms.nms_pack`), and the host half is one copy and
numpy views of it; on the CPU the host half copies the arrays and runs
the NMS in the host library (`evals.nms.run_nms`).

The recorder (`telemetry`) sees both halves: the spans
``parse_pred.device``, ``parse_pred.to_host`` and ``parse_pred.nms`` (the
host NMS on the CPU, the unpacking of the copied buffer on the card); the
device mark ``decode_end`` at the end of the device half, after the NMS
kernel; the anchor of the marks right after the copies to the host (the
stream has drained there); the counters ``parse_pred.d2h_copies`` (the
copies from a device to the host), ``parse_pred.nms_boxes`` (the
foreground boxes NMS is given) and ``parse_pred.kept`` (the detections
returned)."""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..geometry import Obb3D, Pose, rotation_matrix_from_ortho6d
from ..kernels.nms import nms_pack, unpack
from .nms import run_nms


def nms_settings(for_vis: bool):
    """(threshold, same class) of the greedy NMS, the reference's: 0.1
    class-agnostic for eval, 0.2 same-class for vis."""
    return (0.2, True) if for_vis else (0.1, False)


def parse_pred_device(last_out: Dict[str, torch.Tensor],
                      T_world_local: torch.Tensor,
                      track_scale: Sequence[float],
                      for_vis: bool = False,
                      num_semcls: Optional[int] = None,
                      enable_nms: bool = True) -> Dict:
    """last_out: final-iteration outputs (B, K, ...). Returns obb_data
    (B, K, 19), corners_local / corners_world (B, K, 8, 3), scores, labels,
    valid (inside the track scale's x and z bounds; everything when
    `for_vis`), sem_cls_prob. On the card also ``packed``, the NMS
    kernel's buffer of all of them with ``pred_mask`` (`num_semcls`
    required; `enable_nms` False keeps every box), and ``nms``, the
    (num_semcls, enable_nms) it ran with, which the host half takes."""
    with telemetry.span("parse_pred.device"):
        out = _parse_pred_device(last_out, T_world_local, track_scale,
                                 for_vis)
        if out["scores"].is_cuda:
            if num_semcls is None:
                raise ValueError("parse_pred_device: on the card the NMS "
                                 "runs here; give num_semcls")
            out["packed"] = nms_pack(
                out["obb_data"], out["corners_local"], out["corners_world"],
                out["scores"], out["sem_cls_prob"], out["labels"],
                out["valid"], num_semcls, *nms_settings(for_vis),
                nms=enable_nms)
            out["nms"] = (num_semcls, enable_nms)
        telemetry.mark("decode_end")
    return out


def _parse_pred_device(last_out, T_world_local, track_scale, for_vis):
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


def finish_parse_pred(dev: Dict, num_semcls: Optional[int] = None,
                      enable_nms: bool = True, for_vis: bool = False
                      ) -> Dict[str, np.ndarray]:
    """Host half: the detections as numpy arrays, ``pred_mask`` = kept by
    the greedy NMS in the local frame (`nms_settings`) and valid. On the
    card: one copy of the device half's ``packed`` buffer, unpacked, with
    the NMS settings the device half ran with (the arguments are not
    read); on the CPU: the arrays, then the NMS in the host library with
    the settings given here (`num_semcls` required)."""
    packed = dev.get("packed")
    if packed is None and next(iter(dev.values())).is_cuda:
        raise ValueError("finish_parse_pred: the card's device half packs "
                         "its detections (parse_pred_device with "
                         "num_semcls)")
    if packed is not None:
        num_semcls, enable_nms = dev["nms"]
    elif num_semcls is None:
        raise ValueError("finish_parse_pred: the CPU route runs the NMS "
                         "here; give num_semcls")
    telemetry.resolve()        # the host is about to wait on the copies
    with telemetry.span("parse_pred.to_host") as phase:
        if packed is not None:
            packed, copies = packed.cpu().numpy(), 1
        else:
            host, copies = {k: v.cpu().numpy() for k, v in dev.items()}, 0
        telemetry.anchor()
        if enable_nms:
            phase.next("parse_pred.nms")
        if packed is not None:
            host = unpack(packed)
        else:
            host["pred_mask"] = host["valid"]
            if enable_nms:
                thresh, same = nms_settings(for_vis)
                host["pred_mask"] = host["valid"] & run_nms(
                    host["corners_local"], host["labels"], host["scores"],
                    num_semcls, thresh,
                    "nms_3d_faster_samecls" if same else "nms_3d_faster")
    telemetry.count_later(functools.partial(
        _parse_counts, copies, host["labels"], host["pred_mask"], num_semcls,
        enable_nms))
    host["pred_corners_world"] = host["corners_world"]
    return host


def _parse_counts(copies, labels, pred_mask, num_semcls, nms
                  ) -> Dict[str, int]:
    counts = {"parse_pred.kept": int(pred_mask.sum())}
    if copies:
        counts["parse_pred.d2h_copies"] = copies
    if nms:
        counts["parse_pred.nms_boxes"] = int((labels != num_semcls).sum())
    return counts


def parse_pred(last_out: Dict[str, torch.Tensor],
               T_world_local: torch.Tensor, track_scale: Sequence[float],
               num_semcls: int, enable_nms: bool = True,
               for_vis: bool = False) -> Dict[str, np.ndarray]:
    """Device parse + NMS → numpy dict ready for F1Calculator.step."""
    dev = parse_pred_device(last_out, T_world_local, track_scale, for_vis,
                            num_semcls, enable_nms)
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

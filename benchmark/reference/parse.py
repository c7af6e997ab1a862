"""Detections from the last iteration's outputs, in NumPy: the reference
of the eval and served paths' post-processing.

Per query: score = the highest class probability, label = its class;
the box from the center, the size and the rotation decoded from ortho6d
(Gram–Schmidt); its 8 corners in the snippet's local frame and in the
world frame. A box counts where its center lies inside the track box's x
and z bounds, and where a greedy 3D non-maximum suppression over the
axis-aligned bounds of its local corners keeps it: in descending score
(ties in index order), a foreground box is kept unless a kept box
overlaps it by an IoU above 0.1. Background boxes (label = num_semcls)
are never kept.

Given `nms_corners` (the local corners the checked program decoded, which
the comparison holds to these within 1e-4 m), the suppression runs on
those, in float64 as the program's: a pair whose IoU lies within
round-off of the threshold then cannot tip the comparison."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

SIGNS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64)


def rot_from_ortho6d(o):
    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)
    x = unit(o[..., 0:3])
    z = unit(np.cross(x, o[..., 3:6]))
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def greedy_nms(lo, hi, scores, labels, num_semcls, thresh=0.1):
    """(K,) keep mask of one sample."""
    K = len(scores)
    keep = np.zeros(K, bool)
    fg = labels != num_semcls
    vol = np.prod(hi - lo, axis=-1)
    kept = []
    for i in np.argsort(-scores, kind="stable"):
        if not fg[i]:
            continue
        ok = True
        for j in kept:
            inter = np.prod(np.maximum(0.0, np.minimum(hi[i], hi[j])
                                       - np.maximum(lo[i], lo[j])))
            if inter / (vol[i] + vol[j] - inter) > thresh:
                ok = False
                break
        if ok:
            kept.append(i)
            keep[i] = True
    return keep


def parse(last: Dict[str, np.ndarray], Twl: np.ndarray,
          track_scale: Sequence[float], num_semcls: int,
          nms_corners: Optional[np.ndarray] = None
          ) -> Dict[str, np.ndarray]:
    """last: one iteration's outputs (B, K, ...) as float arrays; Twl
    (B, 1, 12). → scores, labels, corners_world (B, K, 8, 3), valid and
    pred_mask (B, K)."""
    prob = last["sem_cls_prob"].astype(np.float64)
    scores, labels = prob.max(-1), prob.argmax(-1)
    center = last["center_unnormalized"].astype(np.float64)
    size = last["size_unnormalized"].astype(np.float64)
    R = rot_from_ortho6d(last["ortho6d"].astype(np.float64))  # (B,K,3,3)
    half = size / 2.0
    corners_obj = -half[..., None, :] + size[..., None, :] * SIGNS
    local = np.einsum("bkij,bknj->bkni", R, corners_obj) + center[..., None, :]
    T = Twl.reshape(-1, 12).astype(np.float64)
    Rw, tw = T[:, :9].reshape(-1, 3, 3), T[:, 9:]
    world = np.einsum("bij,bknj->bkni", Rw, local) + tw[:, None, None, :]
    ts = track_scale
    valid = ((center[..., 0] > ts[0]) & (center[..., 0] < ts[1])
             & (center[..., 2] > ts[4]) & (center[..., 2] < ts[5]))
    box = local if nms_corners is None else nms_corners.astype(np.float64)
    keep = np.stack([greedy_nms(box[b].min(1), box[b].max(1), scores[b],
                                labels[b], num_semcls)
                     for b in range(len(scores))])
    return {"scores": scores, "labels": labels, "corners_world": world,
            "valid": valid, "pred_mask": keep & valid}

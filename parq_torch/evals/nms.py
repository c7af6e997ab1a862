"""3D NMS over axis-aligned bounds of box corners (port of
parq_tpu/evals/nms.py): the host greedy pass, class-agnostic
(`nms_3d_faster`, eval) or same-class (`nms_3d_faster_samecls`, vis), in
the port's host C++ library (`parq_torch.native.nms3d`, as the JAX package
runs its own) with `greedy_nms` its plain numpy version; and
`nms_mask_device`, the masked fixed-K O(K²) greedy pass in torch on the
tensors' device."""
from __future__ import annotations

import numpy as np
import torch

from .. import native


def corners_to_aabb_rows(pred_corners: np.ndarray, scores: np.ndarray,
                         labels: np.ndarray) -> np.ndarray:
    """(B, K, 8, 3) corners → (B, K, 8) rows [min xyz, max xyz, score,
    class]."""
    rows = np.zeros(pred_corners.shape[:2] + (8,))
    rows[..., 0:3] = pred_corners.min(axis=2)
    rows[..., 3:6] = pred_corners.max(axis=2)
    rows[..., 6] = scores
    rows[..., 7] = labels
    return rows


def greedy_nms(boxes: np.ndarray, overlap_threshold: float,
               same_class: bool = False) -> list:
    """Score-descending greedy pick over (n, 8) rows; with `same_class`
    only boxes of the pick's class are suppressed. Boxes of equal score go
    in index order, as in `native.nms3d` and `nms_mask_device`."""
    if len(boxes) == 0:
        return []
    x1, y1, z1, x2, y2, z2 = (boxes[:, i] for i in range(6))
    score = boxes[:, 6]
    cls = boxes[:, 7]
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)
    order = np.argsort(-score, kind="stable")[::-1]
    pick = []
    while order.size:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        lx = np.maximum(0, np.minimum(x2[i], x2[rest])
                        - np.maximum(x1[i], x1[rest]))
        ly = np.maximum(0, np.minimum(y2[i], y2[rest])
                        - np.maximum(y1[i], y1[rest]))
        lz = np.maximum(0, np.minimum(z2[i], z2[rest])
                        - np.maximum(z1[i], z1[rest]))
        inter = lx * ly * lz
        o = inter / (area[i] + area[rest] - inter)
        if same_class:
            o = o * (cls[i] == cls[rest])
        order = rest[o <= overlap_threshold]
    return pick


def run_nms(pred_corners: np.ndarray, labels: np.ndarray,
            scores: np.ndarray, num_semcls: int, overlap_threshold: float,
            nms_type: str = "nms_3d_faster") -> np.ndarray:
    """(B, K, 8, 3) corners → (B, K) bool keep mask; background boxes
    (label == num_semcls) are never kept."""
    B, K = pred_corners.shape[:2]
    rows = corners_to_aabb_rows(pred_corners, scores, labels)
    same = nms_type == "nms_3d_faster_samecls"
    mask = np.zeros((B, K), bool)
    for b in range(B):
        fg = np.where(labels[b] != num_semcls)[0]
        mask[b, fg[native.nms3d(rows[b, fg], overlap_threshold, same)]] = True
    return mask


def nms_mask_device(corners: torch.Tensor, scores: torch.Tensor,
                    labels: torch.Tensor, num_semcls: int,
                    overlap_threshold: float,
                    same_class: bool = False) -> torch.Tensor:
    """Greedy NMS on the tensors' device with no host sync: corners (K, 8,
    3), scores (K,), labels (K,) int → (K,) bool. In score order (a stable
    sort, as jnp.argsort), a foreground box is kept iff no higher-ranked
    kept box overlaps it beyond the threshold."""
    lo, hi = corners.amin(dim=1), corners.amax(dim=1)
    inter = (torch.minimum(hi[:, None], hi[None])
             - torch.maximum(lo[:, None], lo[None])).clamp(min=0.0).prod(-1)
    vol = (hi - lo).prod(-1)
    iou = inter / (vol[:, None] + vol[None] - inter + 1e-12)
    if same_class:
        iou = iou * (labels[:, None] == labels[None])
    order = torch.argsort(-scores, stable=True)
    over = iou[order][:, order] > overlap_threshold      # in rank order
    fg = (labels != num_semcls)[order]
    keep = torch.zeros_like(fg)
    for i in range(scores.shape[0]):
        keep[i] = fg[i] & ~(keep[:i] & over[i, :i]).any()
    out = torch.zeros_like(keep)
    out[order] = keep
    return out

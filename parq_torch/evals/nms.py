"""Greedy 3D NMS over axis-aligned bounds of box corners, on the host:
a numpy copy of the class-agnostic eval variant of parq_tpu/evals/nms.py
(corners_to_aabb_rows, _greedy, run_nms without the native library)."""
from __future__ import annotations

import numpy as np


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


def greedy_nms(boxes: np.ndarray, overlap_threshold: float) -> list:
    """Class-agnostic score-descending greedy pick over (n, 8) rows."""
    if len(boxes) == 0:
        return []
    x1, y1, z1, x2, y2, z2 = (boxes[:, i] for i in range(6))
    score = boxes[:, 6]
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)
    order = np.argsort(score)
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
        order = rest[o <= overlap_threshold]
    return pick


def run_nms(pred_corners: np.ndarray, labels: np.ndarray,
            scores: np.ndarray, num_semcls: int,
            overlap_threshold: float) -> np.ndarray:
    """(B, K, 8, 3) corners → (B, K) bool keep mask; background boxes
    (label == num_semcls) are never kept."""
    B, K = pred_corners.shape[:2]
    rows = corners_to_aabb_rows(pred_corners, scores, labels)
    mask = np.zeros((B, K), bool)
    for b in range(B):
        fg = np.where(labels[b] != num_semcls)[0]
        pick = greedy_nms(rows[b, fg], overlap_threshold)
        mask[b, fg[pick]] = True
    return mask

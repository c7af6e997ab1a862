"""PETR's NMS-free decode (mmdet3d plugin's NMSFreeCoder with
denormalize_bbox), with static shapes: a device half that ranks, gathers
and decodes the top `max_num` of a layer's Q · C class scores, and a host
half that brings them over in one copy.

Per sample: scores = sigmoid(logits) over the flattened (query, class)
grid, the top `max_num` (label = index % C, query = index // C), their
boxes decoded to (cx, cy, cz, w, l, h, yaw, vx, vy): sizes exp'd, yaw =
atan2(sin, cos); a detection is kept where its centre lies inside
`post_center_range` (both ends included). NMSFreeCoder takes torch.topk
over the sigmoid scores; sigmoid is monotonic, so the port ranks the f32
logits instead, with a stable sort (ties by index, lower first): the order
is then fixed by the logits alone, in both halves and in the reference,
and a rounding of the sigmoid cannot reorder two detections. The kept
mask stands in for NMSFreeCoder's boolean indexing, so every shape is
static and the device half can sit in a CUDA graph.

The recorder (`telemetry`) sees both halves: the spans
``petr_decode.device`` and ``petr_decode.to_host``; the device mark
``decode_end`` at the end of the device half; the anchor of the marks
right after the copy to the host; the counters ``petr_decode.d2h_copies``
(1 a call from a card) and ``petr_decode.kept`` (the detections kept)."""
from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch

from .. import telemetry


def petr_decode_device(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                       post_center_range: Sequence[float], max_num: int = 300
                       ) -> torch.Tensor:
    """cls_scores (B, Q, C) logits, bbox_preds (B, Q, 10) as PETRHead's
    last layer gives them → (B, max_num, 13) float32 rows, best first:
    cx, cy, cz, w, l, h, yaw, vx, vy, score, label, query, kept (0/1); the
    row a detection takes on the device and in its one copy."""
    with telemetry.span("petr_decode.device"):
        out = _decode(cls_scores, bbox_preds, post_center_range, max_num)
        telemetry.mark("decode_end")
    return out


def _decode(cls_scores, bbox_preds, post_center_range, max_num):
    B, Q, C = cls_scores.shape
    logits = cls_scores.float().reshape(B, Q * C)
    order = torch.sort(logits, dim=-1, descending=True,
                       stable=True).indices[:, :max_num]
    scores = torch.sigmoid(torch.gather(logits, 1, order))
    labels = order % C
    query = torch.div(order, C, rounding_mode="floor")
    box = torch.gather(bbox_preds.float(), 1,
                       query[..., None].expand(-1, -1, bbox_preds.shape[-1]))
    centre = torch.cat([box[..., 0:2], box[..., 4:5]], dim=-1)
    size = torch.exp(torch.cat([box[..., 2:4], box[..., 5:6]], dim=-1))
    yaw = torch.atan2(box[..., 6:7], box[..., 7:8])
    r = post_center_range
    keep = torch.ones_like(scores, dtype=torch.bool)
    for i in range(3):
        keep &= (centre[..., i] >= r[i]) & (centre[..., i] <= r[i + 3])
    return torch.cat([centre, size, yaw, box[..., 8:10], scores[..., None],
                      labels[..., None].float(), query[..., None].float(),
                      keep[..., None].float()], dim=-1)


def finish_petr_decode(packed: torch.Tensor) -> Dict[str, np.ndarray]:
    """Host half: the packed rows to the host in one copy → boxes (B, K,
    9) float32 (cx, cy, cz, w, l, h, yaw, vx, vy), scores (B, K), labels,
    query (B, K) int64, keep (B, K) bool."""
    telemetry.resolve()        # the host is about to wait on the copy
    with telemetry.span("petr_decode.to_host"):
        rows = packed.cpu().numpy()
        telemetry.anchor()
    host = {"boxes": rows[..., :9], "scores": rows[..., 9],
            "labels": rows[..., 10].astype(np.int64),
            "query": rows[..., 11].astype(np.int64),
            "keep": rows[..., 12] > 0.5}
    telemetry.count_later(functools.partial(
        _counts, int(packed.is_cuda), host["keep"]))
    return host


def _counts(copies: int, keep: np.ndarray) -> Dict[str, int]:
    counts = {"petr_decode.kept": int(keep.sum())}
    if copies:
        counts["petr_decode.d2h_copies"] = copies
    return counts


def petr_decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                post_center_range: Sequence[float], max_num: int = 300
                ) -> Dict[str, np.ndarray]:
    """The device half, then the host half: the detections as numpy."""
    return finish_petr_decode(petr_decode_device(
        cls_scores, bbox_preds, post_center_range, max_num))

"""Sequence-level F1 evaluation with cross-snippet track association.

Host-side, stateful across snippets — the reference's ODAM-derived protocol
(ref: utils/f1_eval.py:254-502): per scene, detections are associated to
existing tracks by 3D-IoU Hungarian matching (keep the best-scoring box per
track), GT merged the same way; at epoch end, per-class greedy TP matching at
IoU ∈ {0.25, 0.5, 0.7} yields per-class and micro-averaged P/R/F1.

This is deliberately NOT on-device: the association is order-dependent and
data-dependent (SURVEY §7.3 #6). With sharded eval, re-serialize per-scene
streams before feeding `step`.

Port of parq_tpu/evals/f1.py. The IoU matrices come from the port's host
C++ library (`parq_torch.native.iou3d_matrix`, the formula of `iou3d`
with its clip repair; the tests hold the two to 1e-9), as the JAX package
takes them from its own.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from .. import native
from .iou3d import to_odam

CARE_CLASSES = {
    0: "chair", 1: "table", 2: "cabinet", 3: "trash bin", 4: "bookshelf",
    5: "display", 6: "sofa", 7: "bathtub", 8: "other",
}


def _associate(dets: List, trks: List, iou_thresh: float):
    """IoU-Hungarian association; returns (matches, unmatched_det_indices).
    Entries are [cls, corners(8,3), score, trk_id]."""
    if not dets or not trks:
        return [], list(range(len(dets)))
    iou_matrix = _pairwise_iou(dets, trks)
    rows, cols = linear_sum_assignment(-iou_matrix)
    matches = [(r, c) for r, c in zip(rows, cols)
               if iou_matrix[r, c] >= iou_thresh]
    matched_d = {m[0] for m in matches}
    unmatched = [d for d in range(len(dets)) if d not in matched_d]
    return matches, unmatched


def _pairwise_iou(predictions, gts) -> np.ndarray:
    """(n_pred, n_gt) 3D-IoU matrix. Computed once per
    scene and reused by every IoU threshold — the reference recomputes a
    fresh iou3d per (pred, gt, threshold) triple (f1_eval.py:36-62), which
    is O(3·P·G) qhull calls on full ScanNet val."""
    if not predictions or not gts:
        return np.zeros((len(predictions), len(gts)), np.float32)
    a = np.stack([to_odam(p[1]) for p in predictions])
    b = np.stack([to_odam(g[1]) for g in gts])
    return native.iou3d_matrix(a, b).astype(np.float32)


def match_sequence(total_gts, total_preds, total_tps, predictions, gts,
                   threshold: float, iou_matrix: np.ndarray = None):
    """Greedy per-class TP counting (ref: f1_eval.py:36-62): each
    prediction, in order, claims the first same-class unused GT whose IoU
    exceeds the threshold."""
    if iou_matrix is None:
        iou_matrix = _pairwise_iou(predictions, gts)
    used_gts: List[int] = []
    for gt in gts:
        total_gts[gt[0]] += 1
    for p, prediction in enumerate(predictions):
        pred_class = prediction[0]
        total_preds[pred_class] += 1
        for i, gt in enumerate(gts):
            if gt[0] == pred_class:
                if iou_matrix[p, i] > threshold and i not in used_gts:
                    used_gts.append(i)
                    total_tps[pred_class] += 1


def get_f1(gts: Dict, predictions: Dict, tps: Dict, verbose: bool = True):
    """Micro-averaged accuracy/recall/F1 with the reference's per-class
    skip rule (classes with zero predictions are excluded entirely,
    ref: f1_eval.py:178-215)."""
    per_class = {}
    total_g = total_p = total_t = 0
    for c in CARE_CLASSES:
        if predictions[c] == 0:
            continue
        accu = tps[c] / predictions[c] if gts[c] != 0 else 0
        recall = tps[c] / gts[c] if gts[c] != 0 else 0
        f1 = 2 * accu * recall / (accu + recall) if accu + recall else 0
        per_class[CARE_CLASSES[c]] = {"accuracy": accu, "recall": recall,
                                      "f1": f1}
        if verbose:
            print(f"class {CARE_CLASSES[c]}: accuracy {accu:.4f} "
                  f"recall {recall:.4f} F1 {f1:.4f}")
        total_g += gts[c]
        total_p += predictions[c]
        total_t += tps[c]
    accuracy = total_t / total_p if total_p else 0
    recall = total_t / total_g if total_g else 0
    f1 = 2 * accuracy * recall / (accuracy + recall) if accuracy + recall else 0
    if verbose:
        print(f"average accuracy: {accuracy}, recall: {recall}, F1: {f1}")
    return accuracy, recall, f1, per_class


class F1Calculator:
    """Accumulates per-scene prediction/GT tracks; computes F1 at the end
    (ref: utils/f1_eval.py:254-557)."""

    def __init__(self, conf_thresh: float,
                 f1_iou_thresh=(0.25, 0.5, 0.7), num_semcls: int = 9):
        self.conf_thresh = conf_thresh
        self.f1_iou_thresh = list(f1_iou_thresh)
        self.iou_thresh = 0.1  # association gate (ref: :266)
        self.num_semcls = num_semcls
        self.reset()

    def reset(self):
        self.preds: Dict[str, List] = {}
        self.gts: Dict[str, List] = {}

    # -- per-snippet accumulation ---------------------------------------
    def step(self, outputs: Dict[str, np.ndarray], gt_list: List[Dict]):
        """outputs (host numpy): pred_corners_world (B,K,8,3), sem_cls_prob
        (B,K,C+1), pred_mask (B,K), scene_name list of B strings.
        gt_list: per-sample dicts with 'labels' (n,), 'gt_corners_world'
        (n,8,3)."""
        batch_preds = self._parse_predictions(outputs)
        gts = self._make_gt_list(gt_list)
        self._match_into(self.preds, batch_preds, outputs["scene_name"],
                         keep_best_score=True, renumber=True)
        self._match_into(self.gts, gts, outputs["scene_name"],
                         keep_best_score=True, renumber=False)

    def _parse_predictions(self, outputs):
        corners = outputs["pred_corners_world"]
        probs = outputs["sem_cls_prob"]
        pred_mask = outputs["pred_mask"]
        cls = probs.argmax(-1)
        score = probs.max(-1)
        out = []
        for i in range(corners.shape[0]):
            out.append([
                [int(cls[i, j]), corners[i, j], float(score[i, j]), -1]
                for j in range(corners.shape[1])
                if cls[i, j] != self.num_semcls
                and score[i, j] > self.conf_thresh
                and pred_mask[i, j]
            ])
        return out

    def _make_gt_list(self, gt_list):
        # The reference jitters GT corners with the GLOBAL np.random
        # (ref: f1_eval.py:364) to break IoU ties, which makes F1
        # run-to-run irreproducible. We keep the jitter (same magnitude,
        # same scalar-broadcast shape) but seed it from the corner content
        # plus the box index, so two validate() runs over the same data
        # produce identical metrics regardless of call order (DIVERGENCES
        # #7/#8 seed policy). The index term matters: the jitter exists to
        # break IoU ties, and two DUPLICATE gt boxes seeded on content
        # alone would draw the same jitter and stay tied.
        import zlib
        out = []
        for gt in gt_list:
            labels = np.asarray(gt["labels"])
            corners = np.asarray(gt["gt_corners_world"])
            dets = []
            for j in range(corners.shape[0]):
                c = np.ascontiguousarray(corners[j], dtype=np.float64)
                rng = np.random.default_rng(
                    (zlib.crc32(c.tobytes()) << 16) ^ j)
                dets.append([int(labels[j]),
                             c + rng.standard_normal(1) * 0.001, 1.0, -1])
            out.append(dets)
        return out

    def _match_into(self, store, batch_dets, scene_names,
                    keep_best_score: bool, renumber: bool):
        for i, dets in enumerate(batch_dets):
            scene = scene_names[i]
            if scene not in store:
                if renumber:
                    for tid, det in enumerate(dets):
                        det[-1] = tid
                store[scene] = deepcopy(dets)
                continue
            trks = store[scene]
            matches, unmatched = _associate(dets, trks, self.iou_thresh)
            for d, t in matches:
                dets[d][-1] = trks[t][-1]
                if keep_best_score and trks[t][2] < dets[d][2]:
                    trks[t] = dets[d]
            base = len(trks)
            for k, d in enumerate(unmatched):
                if renumber:
                    dets[d][-1] = base + k
                trks.append(dets[d])
            store[scene] = deepcopy(trks)

    # -- final metrics ---------------------------------------------------
    def compute_metrics(self, verbose: bool = True) -> Dict[str, float]:
        metrics = {}
        # one IoU matrix per scene, shared by all thresholds
        iou_matrices = {
            scene: _pairwise_iou(self.preds[scene], self.gts.get(scene, []))
            for scene in self.preds}
        for threshold in self.f1_iou_thresh:
            total_gts = {k: 0 for k in CARE_CLASSES}
            total_preds = {k: 0 for k in CARE_CLASSES}
            total_tps = {k: 0 for k in CARE_CLASSES}
            for scene in self.preds:
                match_sequence(total_gts, total_preds, total_tps,
                               self.preds[scene], self.gts.get(scene, []),
                               threshold, iou_matrix=iou_matrices[scene])
            accuracy, recall, f1, per_class = get_f1(
                total_gts, total_preds, total_tps, verbose=verbose)
            metrics[f"{threshold}_accuracy"] = accuracy
            metrics[f"{threshold}_recall"] = recall
            metrics[f"{threshold}_f1"] = f1
            for cname, vals in per_class.items():
                metrics[f"{threshold}_{cname}_f1"] = vals["f1"]
        return metrics

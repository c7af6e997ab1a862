from .f1 import CARE_CLASSES, F1Calculator, get_f1, match_sequence
from .iou3d import convex_hull_intersection, iou3d, polygon_clip, to_odam
from .nms import corners_to_aabb_rows, nms_mask_device, run_nms
from .parse_pred import (finish_parse_pred, parse_pred, parse_pred_device,
                         targets_to_gt_list)

__all__ = ["CARE_CLASSES", "F1Calculator", "convex_hull_intersection",
           "corners_to_aabb_rows", "finish_parse_pred", "get_f1", "iou3d",
           "match_sequence", "nms_mask_device", "parse_pred",
           "parse_pred_device", "polygon_clip", "run_nms",
           "targets_to_gt_list", "to_odam"]

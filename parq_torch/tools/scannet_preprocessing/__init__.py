"""Offline ScanNet preprocessing, the port's twin of scripts/scannet_preprocessing/.

It writes the artifacts `parq_torch.data.scannet.ScanNetDataset` (and the
JAX package's loader) read, from the same raw layout, without PIL:

    python -m parq_torch.tools.scannet_preprocessing.parse_scan2cad \\
        --scan2cad full_annotations.json --out anno
    python -m parq_torch.tools.scannet_preprocessing.generate_scannet_anno_snippet \\
        --scans scans --anno anno --out out --split train [--device cpu]

`parse_scan2cad` (`parse_scene`, `generate_anno`) is host numpy.
`generate_scannet_anno_snippet` (`read_scene_poses`, `process_scene`,
`get_roidb`, `main`) runs each frame's depth backprojection, point-in-box
counts and FOV truncation on the device (CUDA unless told otherwise). The
names below are the modules' shared pieces; the two command-line modules
are not imported here, so that `python -m` runs them once.
"""
from .image_io import (depth_meters, jpeg_size, read_depth,
                       read_depth_samples, read_pgm, read_png_gray)
from .processing_utils import (CATID_TO_NAME, CLASS_TO_INDEX_RAYTRAN,
                               catids_to_labels, depth_to_point_cloud,
                               depth_to_points, fov_truncation_ratio,
                               fov_truncation_ratio_plain, get_level,
                               make_corners, points_inside_corners,
                               points_inside_corners_plain, quat_to_matrix,
                               select_keyframes, tqs_to_matrix,
                               view_selection, view_selection_allframes,
                               view_selection_overlap, view_selection_val,
                               view_selection_w1)

__all__ = [
    "CATID_TO_NAME", "CLASS_TO_INDEX_RAYTRAN", "catids_to_labels",
    "depth_meters", "depth_to_point_cloud", "depth_to_points",
    "fov_truncation_ratio", "fov_truncation_ratio_plain", "get_level",
    "jpeg_size", "make_corners",
    "points_inside_corners", "points_inside_corners_plain",
    "quat_to_matrix", "read_depth", "read_depth_samples", "read_pgm",
    "read_png_gray", "select_keyframes", "tqs_to_matrix", "view_selection",
    "view_selection_allframes", "view_selection_overlap",
    "view_selection_val", "view_selection_w1",
]

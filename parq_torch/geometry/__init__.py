from .camera import Camera
from .obb import MAX_BOXES, MAX_SYMS, Obb3D, pad_obbs_np
from .pose import Pose, invert_4x4
from .rays import (denormalize_points, depth_planes, grid_2d, inverse_sigmoid,
                   normalize_points, ray_dirs_snippet)
from .rotation import roty, rotation_matrix_from_ortho6d

__all__ = [
    "Camera", "Obb3D", "MAX_BOXES", "MAX_SYMS", "pad_obbs_np", "Pose",
    "denormalize_points", "depth_planes", "grid_2d", "inverse_sigmoid",
    "invert_4x4",
    "normalize_points", "ray_dirs_snippet",
    "rotation_matrix_from_ortho6d", "roty",
]

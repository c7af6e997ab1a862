from .camera import Camera
from .obb import MAX_BOXES, MAX_SYMS, Obb3D, pad_obbs_np
from .pose import Pose
from .rays import depth_planes, grid_2d, inverse_sigmoid, ray_dirs_snippet
from .rotation import rotation_matrix_from_ortho6d

__all__ = [
    "Camera", "Obb3D", "MAX_BOXES", "MAX_SYMS", "pad_obbs_np", "Pose",
    "depth_planes", "grid_2d", "inverse_sigmoid", "ray_dirs_snippet",
    "rotation_matrix_from_ortho6d",
]

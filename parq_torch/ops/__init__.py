from .deform_conv import ModulatedDeformConv2d
from .grid_sample import grid_sample_bilinear, sample_bilinear_pixels
from .pixel_align import pixel_aligned_features
from .posemb import pos2posemb3d

__all__ = ["ModulatedDeformConv2d", "grid_sample_bilinear", "sample_bilinear_pixels",
           "pixel_aligned_features", "pos2posemb3d"]

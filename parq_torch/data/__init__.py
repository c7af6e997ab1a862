"""Snippet datasets and the resumable loader (port of parq_tpu/data). Every
item is numpy; PIL is imported only where images are opened or resized."""
from .demo import DemoDataset
from .scannet import SYM_MAPPING, ScanNetDataset, SnippetLoader, collate
from .synthetic import SyntheticDataset, make_batch, make_snippet, to_device
from .transforms import (camera_to_gravity_aligned, mat_to_pose12,
                         pad_scannet, pose12_compose, pose12_inverse,
                         resize_images, snippet_transform)

__all__ = ["DemoDataset", "SYM_MAPPING", "ScanNetDataset", "SnippetLoader",
           "SyntheticDataset", "camera_to_gravity_aligned", "collate",
           "make_batch", "make_snippet", "mat_to_pose12", "pad_scannet",
           "pose12_compose", "pose12_inverse", "resize_images",
           "snippet_transform", "to_device"]

"""ARKit demo dataset: fragments.pkl + per-fragment JPEGs, no GT (port of
parq_tpu/data/demo.py; PIL is imported where the images are opened).

Consumes the format documented in the reference's DEMO.md (fragments.pkl
entries: scene / fragment_id / image_ids / extrinsics / intrinsics;
images at `{scene}/images/{id}.jpg` — ref: datasets/demo_dataset.py:64-159).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from .transforms import snippet_transform


class DemoDataset:
    def __init__(self, data_path: str, gt_path: str,
                 num_frames_per_snippet: int = 3, image_size=(320, 240),
                 gravity_aligned: bool = True):
        self.data_path = data_path
        with open(gt_path, "rb") as f:
            self.item_list = pickle.load(f)
        self.num_frames = num_frames_per_snippet
        self.image_size = tuple(image_size)
        self.gravity_aligned = gravity_aligned

    def __len__(self):
        return len(self.item_list)

    def __getitem__(self, idx: int) -> Dict:
        item = self.item_list[idx]
        scene_name = item["scene"]
        image_ids = item["image_ids"]
        from PIL import Image
        imgs = [
            Image.open(os.path.join(self.data_path, scene_name, "images",
                                    f"{i}.jpg"))
            for i in image_ids
        ]
        out = snippet_transform(
            imgs, [np.asarray(k) for k in item["intrinsics"]],
            np.asarray(item["extrinsics"], np.float64),
            bboxes=None,
            image_size=self.image_size,
            gravity_aligned=self.gravity_aligned)
        out["scene_name"] = scene_name
        out["snippet_id"] = int(item["fragment_id"])
        return out

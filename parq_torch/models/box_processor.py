"""Class-conditioned mean-size table (port of
parq_tpu/models/box_processor.py:load_mean_size_table)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

# ScanNet 9-category mapping of the reference
TYPE2CLASS = {
    "chair": 0, "table": 1, "cabinet": 2, "trash bin": 3, "bookshelf": 4,
    "display": 5, "sofa": 6, "bathtub": 7, "other": 8,
}
CLASS2TYPE = {v: k for k, v in TYPE2CLASS.items()}


def load_mean_size_table(mean_size_path: Optional[str], num_semcls: int = 9,
                         class2type: Optional[dict] = None) -> np.ndarray:
    """Parse a table like data/average_scan2cad.txt into (num_semcls+1, 3)
    rows: matched classes in class-id order, then [1, 1, 1] for the
    unmatched class ("other") and for background, so rows index by argmax
    class id. `None` selects unit sizes; a given path that is missing is
    an error (sizes are exp(size_scale) · mean_size[cls])."""
    if mean_size_path is None:
        return np.ones((num_semcls + 1, 3), np.float32)
    if not os.path.exists(mean_size_path):
        raise FileNotFoundError(
            f"mean-size table '{mean_size_path}' does not exist")
    class2type = CLASS2TYPE if class2type is None else class2type
    typelong = {}
    with open(mean_size_path) as f:
        for line in f:
            if ":" not in line:
                continue
            type_cat, size = line.split(": ")
            vals = [float(v) for v in
                    size.strip().lstrip("[").rstrip("]").split()]
            typelong[type_cat] = vals[:3]
    rows, saw_unmatched = [], False
    for i in range(num_semcls):
        object_type = class2type.get(i)
        matched = False
        if object_type is not None:
            for key, value in typelong.items():
                if object_type in key.split(","):
                    rows.append(value)
                    matched = True
                    break
        if matched and saw_unmatched:
            raise ValueError(
                f"mean-size table {mean_size_path}: class id {i} matched "
                "after an unmatched class; row indices would shift")
        saw_unmatched = saw_unmatched or not matched
    rows.append([1.0, 1.0, 1.0])  # "other"
    rows.append([1.0, 1.0, 1.0])  # background
    return np.asarray(rows, np.float32)

"""Synthetic snippets for examples, serving specs, tests and the CLIs'
`DATA_PATH synthetic` (numpy copy of parq_tpu/data/synthetic.py:
make_snippet, make_batch, SyntheticDataset).

Deterministic scenes: a few oriented boxes 2-4 m in front of a 3-view
camera rig, rendered as class-colored gaussian splats, embedded in a z-up
world frame.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..geometry.obb import MAX_BOXES, MAX_SYMS, pad_obbs_np


def make_snippet(seed: int, image_size=(64, 48), num_views: int = 3,
                 num_boxes: int = 3, num_semcls: int = 9,
                 scene_name: Optional[str] = None) -> Dict[str, np.ndarray]:
    """One snippet: rgb_img (T, H, W, 3), camera (T, 6), poses (T, 12) /
    (1, 12), obbs_padded (MAX_BOXES, 19), sym (MAX_SYMS,)."""
    rng = np.random.RandomState(seed)
    W, H = image_size
    f = 0.8 * W
    cams = np.tile(np.array([W, H, f, f, W / 2.0, H / 2.0], np.float32),
                   (num_views, 1))
    T_world_camera = []
    for t in range(num_views):
        trans = np.array([0.15 * (t - num_views // 2), 0.0, -0.1 * t])
        T_world_camera.append(
            np.concatenate([np.eye(3).reshape(9), trans]).astype(np.float32))
    T_world_camera = np.stack(T_world_camera)

    centers = np.stack([rng.uniform(-1.0, 1.0, num_boxes),
                        rng.uniform(-0.8, 0.3, num_boxes),
                        rng.uniform(2.0, 4.0, num_boxes)], axis=-1)
    sizes = rng.uniform(0.3, 0.9, (num_boxes, 3))
    yaws = rng.uniform(-np.pi, np.pi, num_boxes)
    labels = rng.randint(0, num_semcls, num_boxes).astype(np.float32)
    syms = rng.randint(0, 4, num_boxes)

    bb3 = np.stack([-sizes[:, 0] / 2, sizes[:, 0] / 2,
                    -sizes[:, 1] / 2, sizes[:, 1] / 2,
                    -sizes[:, 2] / 2, sizes[:, 2] / 2], axis=-1)
    poses = []
    for i in range(num_boxes):
        c, s = np.cos(yaws[i]), np.sin(yaws[i])
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses.append(np.concatenate([R.reshape(9), centers[i]]))
    poses = np.asarray(poses, np.float32)

    imgs = np.full((num_views, H, W, 3), 0.1, np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for t in range(num_views):
        R = T_world_camera[t, :9].reshape(3, 3)
        trans = T_world_camera[t, 9:]
        for i in range(num_boxes):
            pc = R.T @ (centers[i] - trans)
            if pc[2] < 0.3:
                continue
            u = pc[0] / pc[2] * f + W / 2
            v = pc[1] / pc[2] * f + H / 2
            radius = f * max(sizes[i].mean(), 0.1) / pc[2] / 2
            blob = np.exp(-((xx - u) ** 2 + (yy - v) ** 2)
                          / (2 * radius ** 2))
            color = np.array([
                0.3 + 0.7 * ((labels[i] * 37) % 9) / 9.0,
                0.3 + 0.7 * ((labels[i] * 17) % 9) / 9.0,
                0.3 + 0.7 * ((labels[i] * 7) % 9) / 9.0], np.float32)
            imgs[t] += blob[..., None] * color
    imgs = np.clip(imgs, 0.0, 1.0)

    obbs = pad_obbs_np(bb3.astype(np.float32), poses, labels, MAX_BOXES)
    sym = np.full((MAX_SYMS,), -1, np.int32)
    sym[:num_boxes] = syms

    ident = np.concatenate([np.eye(3).reshape(9),
                            np.zeros(3)]).astype(np.float32)
    T_camera_pseudoCam = np.tile(ident, (num_views, 1))
    T_world_pseudoCam = T_world_camera.copy()
    T_world_local = T_world_pseudoCam[
        num_views // 2:num_views // 2 + 1].copy()

    # z-up world: left-compose rotx(+90°) into every T_world_*
    F = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)

    def flip(pose_flat):
        R = pose_flat[..., :9].reshape(*pose_flat.shape[:-1], 3, 3)
        t = pose_flat[..., 9:]
        return np.concatenate(
            [(F @ R).reshape(*pose_flat.shape[:-1], 9), t @ F.T], axis=-1)

    T_world_camera = flip(T_world_camera)
    T_world_pseudoCam = flip(T_world_pseudoCam)
    T_world_local = flip(T_world_local)
    obbs = np.concatenate([obbs[:, :6], flip(obbs[:, 6:18]), obbs[:, 18:]],
                          axis=-1)
    obbs[num_boxes:] = -1.0

    return {
        "scene_name": scene_name or f"synthetic_{seed:04d}",
        "snippet_id": seed,
        "rgb_img": imgs,
        "camera": cams,
        "T_world_camera": T_world_camera,
        "T_camera_pseudoCam": T_camera_pseudoCam,
        "T_world_pseudoCam": T_world_pseudoCam,
        "T_world_local": T_world_local,
        "obbs_padded": obbs,
        "sym": sym,
    }


def make_batch(seeds, **kw) -> Dict[str, np.ndarray]:
    """Collate snippets (stacked numpy; strings as lists)."""
    items = [make_snippet(s, **kw) for s in seeds]
    out = {}
    for k in items[0]:
        if isinstance(items[0][k], np.ndarray):
            out[k] = np.stack([it[k] for it in items])
        else:
            out[k] = [it[k] for it in items]
    return out


class SyntheticDataset:
    """Dataset-shaped wrapper over make_snippet for the loaders and CLIs
    (parq_tpu/data/synthetic.py:142): snippet i is make_snippet(seed + i)
    in scene i mod `scenes`, so the F1 track association sees several
    snippets of one scene."""

    def __init__(self, num_snippets: int = 32, image_size=(64, 48),
                 num_views: int = 3, seed: int = 0, scenes: int = 4):
        self.num_snippets = num_snippets
        self.image_size = tuple(image_size)
        self.num_views = num_views
        self.seed = seed
        self.scenes = scenes

    def __len__(self):
        return self.num_snippets

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scene = idx % self.scenes
        return make_snippet(self.seed + idx, image_size=self.image_size,
                            num_views=self.num_views,
                            scene_name=f"synthetic_scene_{scene:03d}")


def to_device(batch: Dict, keys, device) -> Dict[str, torch.Tensor]:
    """Float32 tensors of `keys` on `device`."""
    return {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                               device=device) for k in keys}

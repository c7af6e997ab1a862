"""ARKitScenes 3DOD dataset (port of parq_tpu/data/arkitscenes.py; PIL is
imported where the images are opened).

Reads the official ARKitScenes 3DOD layout:
  {root}/{video_id}/{video_id}_frames/lowres_wide/{video_id}_{ts}.png
  {root}/{video_id}/{video_id}_frames/lowres_wide_intrinsics/{...}.pincam
  {root}/{video_id}/{video_id}_frames/lowres_wide.traj
  {root}/{video_id}/{video_id}_3dod_annotation.json

Snippets are built on the fly with the same keyframe policy as the ScanNet
preprocessing (≥15° or ≥0.1 m between kept frames, windows of
`num_frames_per_snippet`). ARKit world frame is +y-up, so gravity alignment
uses UP = (0, 1, 0).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..geometry.obb import MAX_BOXES, pad_obbs_np
from .scannet import SYM_PAD
from .transforms import (camera_to_gravity_aligned, mat_to_pose12,
                         pose12_compose, pose12_inverse, resize_images)

ARKIT_CLASSES = [
    "cabinet", "refrigerator", "shelf", "stove", "bed", "sink", "washer",
    "toilet", "bathtub", "oven", "dishwasher", "fireplace", "stool",
    "chair", "table", "tv_monitor", "sofa",
]
ARKIT_CLASS_TO_ID = {c: i for i, c in enumerate(ARKIT_CLASSES)}
UP_ARKIT = np.array([0.0, 1.0, 0.0])


def _axis_angle_to_matrix(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def read_traj(path: str) -> Dict[str, np.ndarray]:
    """lowres_wide.traj → {timestamp_str: 4x4 T_world_camera}.

    Each line: ts rx ry rz tx ty tz (axis-angle world→camera)."""
    out = {}
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) < 7:
                continue
            ts = f"{float(vals[0]):.3f}"
            R_wc = _axis_angle_to_matrix(np.asarray(vals[1:4], np.float64))
            t = np.asarray(vals[4:7], np.float64)
            T_cam_world = np.eye(4)
            T_cam_world[:3, :3] = R_wc
            T_cam_world[:3, 3] = t
            out[ts] = np.linalg.inv(T_cam_world)
    return out


def read_pincam(path: str) -> np.ndarray:
    """.pincam: 'w h fx fy cx cy' → 3x3 K."""
    w, h, fx, fy, cx, cy = np.loadtxt(path)
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def read_annotation(path: str):
    """3dod_annotation.json → (bboxes (n,6), T_world_object (n,4,4),
    labels (n,))."""
    with open(path) as f:
        anno = json.load(f)
    bboxes, poses, labels = [], [], []
    for item in anno.get("data", []):
        obb = item["segments"]["obbAligned"]
        half = np.asarray(obb["axesLengths"], np.float64) / 2.0
        centroid = np.asarray(obb["centroid"], np.float64)
        R = np.asarray(obb["normalizedAxes"], np.float64).reshape(3, 3).T
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = centroid
        bboxes.append([-half[0], half[0], -half[1], half[1],
                       -half[2], half[2]])
        poses.append(T)
        labels.append(ARKIT_CLASS_TO_ID.get(
            item.get("label", ""), len(ARKIT_CLASSES) - 1))
    return (np.asarray(bboxes), np.asarray(poses),
            np.asarray(labels, np.float64))


def _select_keyframes(poses: List[np.ndarray], min_angle=15.0, min_dist=0.1):
    kept = [0]
    for i in range(1, len(poses)):
        Ta, Tb = poses[kept[-1]], poses[i]
        R = Ta[:3, :3].T @ Tb[:3, :3]
        dr = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
        dt = np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])
        if dr >= min_angle or dt >= min_dist:
            kept.append(i)
    return kept


class ARKitScenesDataset:
    def __init__(self, data_path: str, video_ids=None,
                 num_frames_per_snippet: int = 3, image_size=(320, 240),
                 gravity_aligned: bool = True):
        self.root = data_path
        self.num_frames = num_frames_per_snippet
        self.image_size = tuple(image_size)
        self.gravity_aligned = gravity_aligned
        if video_ids is None:
            video_ids = sorted(
                d for d in os.listdir(data_path)
                if os.path.isdir(os.path.join(data_path, d)))
        self.snippets = []
        self._scenes: Dict[str, Dict] = {}
        for vid in video_ids:
            self._index_scene(vid)

    def _index_scene(self, vid: str):
        frames_dir = os.path.join(self.root, vid, f"{vid}_frames")
        traj = read_traj(os.path.join(frames_dir, "lowres_wide.traj"))
        img_dir = os.path.join(frames_dir, "lowres_wide")
        ts_list = sorted(
            f[len(vid) + 1:-4] for f in os.listdir(img_dir)
            if f.endswith(".png"))
        ts_list = [t for t in ts_list if t in traj]
        if not ts_list:
            return
        poses = [traj[t] for t in ts_list]
        kept = _select_keyframes(poses)
        self._scenes[vid] = {"ts": ts_list, "traj": traj,
                             "frames_dir": frames_dir}
        w = self.num_frames
        for s, start in enumerate(range(0, len(kept) - w + 1, w)):
            self.snippets.append(
                (vid, s, [ts_list[k] for k in kept[start:start + w]]))

    def __len__(self):
        return len(self.snippets)

    def __getitem__(self, idx: int) -> Dict:
        vid, snippet_id, ts = self.snippets[idx]
        scene = self._scenes[vid]
        fd = scene["frames_dir"]
        from PIL import Image
        imgs, Ks, poses = [], [], []
        for t in ts:
            imgs.append(Image.open(
                os.path.join(fd, "lowres_wide", f"{vid}_{t}.png")))
            Ks.append(read_pincam(
                os.path.join(fd, "lowres_wide_intrinsics",
                             f"{vid}_{t}.pincam")))
            poses.append(scene["traj"][t])

        bboxes, T_wo, labels = read_annotation(
            os.path.join(self.root, vid, f"{vid}_3dod_annotation.json"))

        imgs_np, intr = resize_images(imgs, Ks, self.image_size)
        rgb = np.stack(imgs_np)
        if rgb.ndim == 3:  # grayscale png
            rgb = np.stack([rgb] * 3, axis=-1)
        rgb = rgb[..., :3] / 255.0

        T_wc = np.stack(poses)
        if self.gravity_aligned:
            T_wp = camera_to_gravity_aligned(T_wc, UP_ARKIT)
        else:
            T_wp = T_wc.copy()
        twc = mat_to_pose12(T_wc)
        twp = mat_to_pose12(T_wp)
        tcp = pose12_compose(pose12_inverse(twc), twp)
        t_sel = len(ts) // 2
        twl = twp[t_sel:t_sel + 1].copy()

        K0 = intr[0]
        W, H = self.image_size
        camera = np.broadcast_to(np.array(
            [W, H, K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]], np.float32),
            (len(ts), 6)).copy()

        if len(bboxes):
            obbs = pad_obbs_np(bboxes.astype(np.float32),
                               mat_to_pose12(T_wo).astype(np.float32),
                               labels.astype(np.float32), MAX_BOXES)
        else:
            obbs = -np.ones((MAX_BOXES, 19), np.float32)
        sym = np.full((SYM_PAD,), -1, np.int32)
        sym[:min(len(bboxes), SYM_PAD)] = 0  # ARKitScenes has no sym tags

        return {
            "scene_name": vid,
            "snippet_id": snippet_id,
            "rgb_img": rgb.astype(np.float32),
            "camera": camera,
            "T_world_camera": twc.astype(np.float32),
            "T_world_pseudoCam": twp.astype(np.float32),
            "T_camera_pseudoCam": tcp.astype(np.float32),
            "T_world_local": twl.astype(np.float32),
            "obbs_padded": obbs,
            "sym": sym,
        }

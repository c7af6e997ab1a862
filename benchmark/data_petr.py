"""Synthetic six-camera samples for the PETR cells, made from the seed.

A sample is what PETR's test pipeline hands the model: six camera images
resized to the configuration's size, BGR in 0..255 (uint8, as decoded),
and each camera's lidar2img (4 x 4, float32). The rig is nuScenes-like:
six cameras around a car, the lidar frame x forward, y left, z up, the
cameras at yaws 0° (front), −55°, 55°, 180°, 110° and −110° (nuScenes'
order: front, front right, front left, back, back left, back right),
0.8 m out from the lidar and 0.3 m below it, with nuScenes' intrinsics
(1600 x 900, f = 1266.4, principal point (816.3, 491.5)) after the test
resize (0.88, so 1408 x 792) and the crop of the top 280 rows that leaves
1408 x 512 (mmdet3d's ResizeCropFlipImage at test time), folded into the
intrinsics; scaled the same way to any other image size. Each sample's rig
is turned by a small seeded calibration jitter (under half a degree about
each axis, a few centimetres), so no two samples share a lidar2img.

The scene: `boxes` = [lo, hi] objects a sample (each count lo..hi equally
often over a pool, in the seed's order), on the ground 4–50 m around the
car, of car-to-pedestrian sizes, one of 10 classes; each is drawn as a
class-coloured splat (`benchmark.data.render`) in every camera that sees
its centre, over a smooth background.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .data import box_counts, render

YAWS_DEG = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)
NUSC = dict(W=1600, H=900, f=1266.4, cx=816.3, cy=491.5)
TEST_RESIZE = 0.88              # max(512 / 900, 1408 / 1600)
CROP_TOP = 280                  # 792 − 512 rows
LIDAR_HEIGHT = 1.84             # the lidar above the ground, m
RENDER_CHUNK = 4                # samples rendered at once on the device


def _rot(axis: int, a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    R = np.zeros(a.shape + (3, 3))
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R[..., axis, axis] = 1.0
    R[..., i, i], R[..., i, j], R[..., j, i], R[..., j, j] = c, -s, s, c
    return R


def intrinsics(image_size) -> np.ndarray:
    """The 3 x 3 intrinsics of a camera at `image_size` (W, H): nuScenes'
    after the test resize and crop, scaled from 1408 x 512 to W x H."""
    W, H = image_size
    s = TEST_RESIZE * W / 1408.0
    return np.array([[NUSC["f"] * s, 0.0, NUSC["cx"] * s],
                     [0.0, NUSC["f"] * s,
                      (NUSC["cy"] * TEST_RESIZE - CROP_TOP) * W / 1408.0],
                     [0.0, 0.0, 1.0]])


def rig(n: int, cams: int, image_size, rng) -> np.ndarray:
    """(n, cams, 4, 4) lidar2img of n samples' rigs (float64)."""
    yaw = np.deg2rad(np.resize(np.array(YAWS_DEG), cams))
    jit = np.deg2rad(rng.uniform(-0.4, 0.4, (n, cams, 3)))
    # camera axes in the lidar frame: x right, y down, z ahead
    ahead = np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)], -1)
    right = np.stack([np.sin(yaw), -np.cos(yaw), np.zeros_like(yaw)], -1)
    down = np.broadcast_to(np.array([0.0, 0.0, -1.0]), ahead.shape)
    R = np.stack([right, down, ahead], -1)                 # lidar ← cam
    R = R[None] @ _rot(0, jit[..., 0]) @ _rot(1, jit[..., 1]) \
        @ _rot(2, jit[..., 2])
    t = 0.8 * ahead[None] + np.array([0.0, 0.0, -0.3]) \
        + rng.uniform(-0.03, 0.03, (n, cams, 3))
    cam2lidar = np.tile(np.eye(4), (n, cams, 1, 1))
    cam2lidar[..., :3, :3], cam2lidar[..., :3, 3] = R, t
    K = np.eye(4)
    K[:3, :3] = intrinsics(image_size)
    return K @ np.linalg.inv(cam2lidar)


def make_pool(n: int, cfg: dict, boxes, seed: int, device
              ) -> Dict[str, torch.Tensor]:
    """n samples as host tensors: img (n, cams, 3, H, W) uint8 BGR,
    lidar2img (n, cams, 4, 4) float32."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 23])
    W, H = cfg["image_size"]
    cams = cfg["num_cams"]
    l2i = rig(n, cams, (W, H), rng)
    counts = box_counts(n, boxes[0], boxes[1], rng)
    K = int(boxes[1])
    dist = rng.uniform(4.0, 50.0, (n, K))
    ang = rng.uniform(-np.pi, np.pi, (n, K))
    size = rng.uniform([0.6, 0.6, 1.0], [2.0, 5.0, 2.0], (n, K, 3))
    centre = np.stack([dist * np.cos(ang), dist * np.sin(ang),
                       size[..., 2] / 2 - LIDAR_HEIGHT], -1)
    label = rng.integers(0, 10, (n, K))
    live = np.arange(K)[None] < counts[:, None]
    hom = np.concatenate([centre, np.ones((n, K, 1))], -1)
    pix = np.einsum("ncij,nkj->ncki", l2i, hom)            # (n, cams, K, 4)
    z = pix[..., 2]
    zc = np.maximum(z, 1e-3)
    u, v = pix[..., 0] / zc, pix[..., 1] / zc
    f = intrinsics((W, H))[0, 0]
    radius = f * size.mean(-1)[:, None] / zc / 2.0
    on = live[:, None] & (z > 0.5) & (u > -W) & (u < 2 * W) & (v > -H) \
        & (v < 2 * H)
    colour = 0.3 + 0.7 * ((label[..., None] * np.array([37, 17, 7])) % 9) / 9
    imgs = []
    for s in range(0, n, RENDER_CHUNK):
        c = slice(s, s + RENDER_CHUNK)
        rgb = render(u[c], v[c], radius[c], on[c], colour[c], H, W, rng,
                     device)                          # (b, cams, H, W, 3)
        bgr = (rgb.flip(-1) * 255.0).round().to(torch.uint8)
        imgs.append(bgr.permute(0, 1, 4, 2, 3).contiguous().cpu())
    return {"img": torch.cat(imgs),
            "lidar2img": torch.tensor(l2i, dtype=torch.float32)}

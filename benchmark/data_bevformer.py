"""Synthetic scenes of six-camera samples for the BEVFormer cell, made
from the seed.

A sample is what BEVFormer's test pipeline hands the model in video test
mode: six camera images at nuScenes' full 1600 x 900, BGR in 0..255
(uint8, as decoded; the model pads them to 1600 x 928), each camera's
lidar2img (4 x 4, float32) and the CAN-bus row (18, float64) as
BEVFormer's nuScenes dataset lays it out: the ego's global position
[0:3], its orientation quaternion (w, x, y, z) [3:7], acceleration
[7:10], rotation rate [10:13], velocity [13:16], and the yaw in radians
[16] and in degrees [17], both in [0, 360°).

The rig is `data_petr`'s nuScenes-like one (six cameras around the car,
nuScenes' order and mounting), at nuScenes' native intrinsics (f =
1266.4, principal point (816.3, 491.5); no resize, no crop), scaled by W
/ 1600 to another image size; its seeded calibration jitter is drawn
once for the scene, so every sample of a scene shares one lidar2img, as
a car's calibration does.

The ego drives a seeded trajectory: from a random global position and
heading, each step of 0.5 s (nuScenes' 2 Hz keyframes) at a speed drawn
in 0–15 m/s and a yaw rate in ±0.3 rad/s. The scene: `boxes` = [lo, hi]
objects a sample (each count lo..hi equally often over a pool, in the
seed's order), on the ground 4–50 m around the car, of car-to-pedestrian
sizes, one of 10 classes, each drawn as a class-coloured splat
(`benchmark.data.render`) in every camera that sees its centre, over a
smooth background.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .data import box_counts, render
from .data_petr import LIDAR_HEIGHT, NUSC, intrinsics, rig

DT = 0.5                        # s between samples
SPEED = (0.0, 15.0)             # m/s
YAW_RATE = 0.3                  # rad/s, either way
RENDER_CHUNK = 2                # samples rendered at once on the device


def native_intrinsics(image_size) -> np.ndarray:
    """The 3 x 3 intrinsics of a camera at nuScenes' native size, scaled
    by W / 1600 to `image_size` (W, H)."""
    s = image_size[0] / NUSC["W"]
    return np.array([[NUSC["f"] * s, 0.0, NUSC["cx"] * s],
                     [0.0, NUSC["f"] * s, NUSC["cy"] * s],
                     [0.0, 0.0, 1.0]])


def scene_rig(cams: int, image_size, rng) -> np.ndarray:
    """(cams, 4, 4) lidar2img of one scene's rig (float64): `data_petr`'s
    rig with its resized-and-cropped intrinsics swapped for the native
    ones."""
    l2i = rig(1, cams, image_size, rng)[0]
    K_petr, K = np.eye(4), np.eye(4)
    K_petr[:3, :3] = intrinsics(image_size)
    K[:3, :3] = native_intrinsics(image_size)
    return K @ np.linalg.inv(K_petr) @ l2i


def trajectory(n: int, rng) -> np.ndarray:
    """(n, 18) float64 CAN-bus rows of a seeded drive."""
    pos = np.array([rng.uniform(300.0, 2000.0), rng.uniform(300.0, 2000.0),
                    0.0])
    yaw = rng.uniform(0.0, 2 * np.pi)
    rows = np.zeros((n, 18))
    for i in range(n):
        speed = rng.uniform(*SPEED)
        rate = rng.uniform(-YAW_RATE, YAW_RATE)
        if i:
            yaw = (yaw + rate * DT) % (2 * np.pi)
            pos = pos + speed * DT * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        rows[i, 0:3] = pos
        rows[i, 3:7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
        rows[i, 7:10] = [rng.normal(0.0, 0.5), rng.normal(0.0, 0.5), 9.81]
        rows[i, 10:13] = [0.0, 0.0, rate]
        rows[i, 13:16] = [speed, 0.0, 0.0]
        rows[i, 16] = yaw
        rows[i, 17] = yaw / np.pi * 180
    return rows


def make_scene(n: int, cfg: dict, boxes, seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """n samples of one scene as host tensors: img (n, cams, 3, H, W)
    uint8 BGR, lidar2img (n, cams, 4, 4) float32, can_bus (n, 18)
    float64."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 24])
    W, H = cfg["image_size"]
    cams = cfg["num_cams"]
    l2i = np.broadcast_to(scene_rig(cams, (W, H), rng), (n, cams, 4, 4))
    can_bus = trajectory(n, rng)
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
    f = native_intrinsics((W, H))[0, 0]
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
        del rgb, bgr
    return {"img": torch.cat(imgs),
            "lidar2img": torch.tensor(np.ascontiguousarray(l2i),
                                      dtype=torch.float32),
            "can_bus": torch.tensor(can_bus, dtype=torch.float64)}

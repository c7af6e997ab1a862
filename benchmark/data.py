"""Synthetic posed snippets, made from the seed: the benchmark's inputs.

A snippet is T views of a short camera path through a room-sized scene
with 1–16 oriented boxes (the count a snippet gets is drawn from a fixed
multiset that every seed shares, in the seed's order, so every seed asks
for the same work). Cameras look along +z of the middle view's frame
with ScanNet-like intrinsics; the world frame is z-up, as ScanNet's.
Images are a smooth background with one class-coloured splat per box
that projects into the view. Geometry comes from NumPy's generator on
the host; the images are rendered on `device` in one vectorised pass.

Everything a run feeds the program and the reference comes from here.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

FLIP = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])   # y-down → z-up


def box_counts(n: int, lo: int, hi: int, rng) -> np.ndarray:
    """n box counts: lo..hi repeated evenly, in the seed's order."""
    return rng.permutation(np.resize(np.arange(lo, hi + 1), n))


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(a), np.ones_like(a)
    return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                     np.stack([-s, z, c], -1)], -2)


def _pose(R, t):
    return np.concatenate([R.reshape(R.shape[:-2] + (9,)), t], -1)


def make_pool(n: int, views: int, image_size: Sequence[int], boxes,
              seed: int, device) -> Dict[str, torch.Tensor]:
    """n snippets as host tensors: rgb_img (n, T, H, W, 3) float32 in
    [0, 1], camera (n, T, 6), T_camera_pseudoCam, T_world_pseudoCam
    (n, T, 12) and T_world_local (n, 1, 12)."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 17])
    W, H = image_size
    T = views
    f = 0.9 * W
    cam = np.tile(np.array([W, H, f, f, W / 2.0, H / 2.0]), (n, T, 1))
    # camera path in the middle view's frame (x right, y down, z ahead)
    step = rng.uniform(0.08, 0.2, (n, 1))
    turn = rng.uniform(-0.08, 0.08, (n, 1))
    k = np.arange(T)[None] - T // 2
    t_cam = np.stack([step * k, 0.02 * k * rng.uniform(-1, 1, (n, 1)),
                      np.broadcast_to(-0.05 * np.abs(k), (n, T))],
                     -1)                                       # (n, T, 3)
    R_cam = _yaw(turn * k)                                     # (n, T, 3, 3)
    # scene placement: the middle view's pose in a y-down world, then z-up
    base_R = _yaw(rng.uniform(-np.pi, np.pi, n))
    base_t = np.stack([rng.uniform(-2, 2, n), rng.uniform(-0.3, 0.3, n),
                       rng.uniform(-2, 2, n)], -1)
    Rw = FLIP @ (base_R[:, None] @ R_cam)
    tw = (FLIP @ ((base_R[:, None] @ t_cam[..., None])[..., 0]
                  + base_t[:, None])[..., None])[..., 0]
    T_world_cam = _pose(Rw, tw)
    T_world_local = T_world_cam[:, T // 2:T // 2 + 1]

    counts = box_counts(n, boxes[0], boxes[1], rng)
    K = int(boxes[1])
    center = np.stack([rng.uniform(-1.2, 1.2, (n, K)),
                       rng.uniform(-0.8, 0.4, (n, K)),
                       rng.uniform(1.5, 4.5, (n, K))], -1)    # middle view
    size = rng.uniform(0.3, 1.2, (n, K, 3))
    label = rng.integers(0, 9, (n, K))
    live = np.arange(K)[None] < counts[:, None]

    # the views: each live box's center projected into each view
    rel = center[:, None] - t_cam[:, :, None]                  # (n, T, K, 3)
    pc = (R_cam[:, :, None].swapaxes(-1, -2) @ rel[..., None])[..., 0]
    z = np.maximum(pc[..., 2], 1e-3)
    u = pc[..., 0] / z * f + W / 2.0
    v = pc[..., 1] / z * f + H / 2.0
    radius = f * size.mean(-1)[:, None] / z / 2.0
    on = live[:, None] & (pc[..., 2] > 0.3)
    colour = 0.3 + 0.7 * ((label[..., None] * np.array([37, 17, 7])) % 9) / 9
    images = render(u, v, radius, on, colour, H, W, rng, device)
    f32 = torch.float32
    return {
        "rgb_img": images.cpu(),
        "camera": torch.tensor(cam, dtype=f32),
        "T_camera_pseudoCam": torch.tensor(
            np.tile(np.concatenate([np.eye(3).reshape(9), np.zeros(3)]),
                    (n, T, 1)), dtype=f32),
        "T_world_pseudoCam": torch.tensor(T_world_cam, dtype=f32),
        "T_world_local": torch.tensor(T_world_local, dtype=f32),
    }


def render(u, v, radius, on, colour, H, W, rng, device) -> torch.Tensor:
    """(n, T, H, W, 3) float32 in [0, 1]: a smooth background (a low
    sum of sines) plus one gaussian splat per projected box."""
    n, T, K = u.shape
    dev = torch.device(device)
    g = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ph = g(rng.uniform(0, 2 * np.pi, (n, T, 3)))
    fr = g(rng.uniform(0.005, 0.03, (n, T, 2)))
    bg = 0.3 + 0.15 * torch.sin(
        fr[..., 0, None, None, None] * xx[..., None] * 6.28
        + fr[..., 1, None, None, None] * yy[..., None] * 6.28
        + ph[:, :, None, None, :])                              # (n,T,H,W,3)
    img = bg
    U, V, Rr = g(u), g(v), g(np.maximum(radius, 1.0))
    On, C = g(on), g(colour)
    for k in range(K):                    # one splat a box, all snippets
        d2 = ((xx - U[:, :, k, None, None]) ** 2
              + (yy - V[:, :, k, None, None]) ** 2)
        blob = torch.exp(-d2 / (2 * Rr[:, :, k, None, None] ** 2)) \
            * On[:, :, k, None, None]
        img = img + blob[..., None] * C[:, None, None, None, k]
    return img.clamp(0.0, 1.0)


def take(pool: Dict[str, torch.Tensor], idx, keys) -> Dict[str, torch.Tensor]:
    """The snippets `idx` of `pool` (a slice or index list) for `keys`."""
    return {k: pool[k][idx] for k in keys}

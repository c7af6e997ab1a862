"""Host-side data transforms (numpy copy of parq_tpu/data/transforms.py):
PIL bilinear resize, ScanNet 1296×968 pad, intrinsic rescale, gravity
alignment, middle-frame local frame.

Output layout is channels-last: rgb_img (T, H, W, 3) float32 in [0, 1].
PIL is imported inside the functions that resize or pad images, so the
module imports on a machine without it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..geometry.obb import MAX_BOXES, pad_obbs_np

UP_W = {"SCANNET": np.array([0.0, 0.0, 1.0])}


def pad_scannet(img, intrinsics: np.ndarray):
    """1296×968 → pad 2px top/bottom to 1296×972 (4:3), cy += 2
    (ref: transforms.py:65-74)."""
    from PIL import ImageOps
    w, h = img.size
    if w == 1296 and h == 968:
        img = ImageOps.expand(img, border=(0, 2))
        intrinsics = intrinsics.copy()
        intrinsics[1, 2] += 2
    return img, intrinsics


def resize_images(images, intrinsics_list, size=(320, 240)):
    """PIL bilinear resize + intrinsic rescale (ref: transforms.py:77-100)."""
    from PIL import Image
    out_imgs, out_intr = [], []
    for im, intr in zip(images, intrinsics_list):
        intr = np.array(intr, np.float64)
        im, intr = pad_scannet(im, intr)
        w, h = im.size
        im = im.resize(size, Image.BILINEAR)
        intr = intr.copy()
        intr[0, :] /= w / size[0]
        intr[1, :] /= h / size[1]
        out_imgs.append(np.asarray(im, np.float32))
        out_intr.append(intr)
    return out_imgs, out_intr


def _normalize(v, axis=-1):
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    n = np.where(n == 0, 1.0, n)
    return v / n


def camera_to_gravity_aligned(T_world_camera: np.ndarray,
                              up_w: np.ndarray) -> np.ndarray:
    """(T, 4, 4) camera poses → gravity-aligned pseudoCam poses: column 1
    (y axis) = world up, column 2 = camera forward rejected onto the ground
    normal, column 0 completes the frame (ref: transforms.py:32-44)."""
    T_wv = T_world_camera.copy()
    cam_forward = T_world_camera[..., :3, 2]
    up = _normalize(up_w)
    proj = (cam_forward @ up)[..., None] * up
    col2 = _normalize(cam_forward - proj)
    col1 = np.broadcast_to(up, col2.shape)
    col0 = _normalize(np.cross(col1, col2))
    T_wv[..., :3, 0] = col0
    T_wv[..., :3, 1] = col1
    T_wv[..., :3, 2] = col2
    return T_wv


def mat_to_pose12(T: np.ndarray) -> np.ndarray:
    """(…, 4, 4) → flat (…, 12) [R(9), t(3)]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return np.concatenate([R.reshape(*R.shape[:-2], 9), t], axis=-1)


def pose12_inverse(p: np.ndarray) -> np.ndarray:
    R = p[..., :9].reshape(*p.shape[:-1], 3, 3)
    t = p[..., 9:]
    Rt = np.swapaxes(R, -1, -2)
    return np.concatenate(
        [Rt.reshape(*p.shape[:-1], 9),
         -np.einsum("...ij,...j->...i", Rt, t)], axis=-1)


def pose12_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a ∘ b with T_B2C.compose(T_A2B) semantics."""
    Ra = a[..., :9].reshape(*a.shape[:-1], 3, 3)
    Rb = b[..., :9].reshape(*b.shape[:-1], 3, 3)
    ta, tb = a[..., 9:], b[..., 9:]
    R = Ra @ Rb
    t = ta + np.einsum("...ij,...j->...i", Ra, tb)
    return np.concatenate([R.reshape(*R.shape[:-2], 9), t], axis=-1)


def snippet_transform(
    images,                      # list of T PIL images
    intrinsics,                  # list of T (3,3) or (4,4) arrays
    T_world_camera: np.ndarray,  # (T, 4, 4)
    bboxes: Optional[np.ndarray] = None,        # (n, 6)
    T_world_object: Optional[np.ndarray] = None,  # (n, 4, 4)
    labels: Optional[np.ndarray] = None,         # (n,)
    image_size=(320, 240),
    gravity_aligned: bool = True,
    dataset_type: str = "SCANNET",
    frame_selection: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Full per-snippet pipeline (ref: transforms.py:211-237 Compose order:
    Resize → ToTensor → Normalize → Convert2Objects → GravityAligned →
    SnippetLocal)."""
    T = len(images)
    imgs, intr = resize_images(images, intrinsics, image_size)
    rgb = np.stack(imgs) / 255.0  # (T, H, W, 3)

    # camera params from frame 0, expanded to all views (ref: :144-158)
    K = intr[0]
    w, h = image_size
    camera = np.array([w, h, K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    camera = np.broadcast_to(camera, (T, 6)).copy()

    T_world_camera = np.asarray(T_world_camera, np.float64)
    if gravity_aligned:
        T_world_pseudoCam = camera_to_gravity_aligned(
            T_world_camera, UP_W[dataset_type])
    else:
        T_world_pseudoCam = T_world_camera.copy()

    twc = mat_to_pose12(T_world_camera)
    twp = mat_to_pose12(T_world_pseudoCam)
    tcp = pose12_compose(pose12_inverse(twc), twp)

    # local frame = middle frame pseudoCam (ref: :191-208)
    t_sel = int(T * frame_selection)
    twl = twp[t_sel:t_sel + 1].copy()

    out = {
        "rgb_img": rgb.astype(np.float32),
        "camera": camera.astype(np.float32),
        "T_world_camera": twc.astype(np.float32),
        "T_world_pseudoCam": twp.astype(np.float32),
        "T_camera_pseudoCam": tcp.astype(np.float32),
        "T_world_local": twl.astype(np.float32),
    }
    if bboxes is not None and len(bboxes):
        out["obbs_padded"] = pad_obbs_np(
            np.asarray(bboxes, np.float32),
            mat_to_pose12(np.asarray(T_world_object, np.float64)).astype(np.float32),
            np.asarray(labels, np.float32), MAX_BOXES)
    elif bboxes is not None:
        out["obbs_padded"] = -np.ones((MAX_BOXES, 19), np.float32)
    return out

"""Visualization: 3D box wireframe overlays, feature-map PCA and PNG files
(port of parq_tpu/utils/vis.py, ref utils/parq_utils.py:108-211 and
utils/vis_utils.py:6-17).

Host work on numpy arrays. The JAX package draws its wireframes with
cv2.line and writes PNGs with PIL; the port needs neither (the card's
machine has neither):
- `draw_segment` rasterizes a segment of thickness 2 itself: every pixel
  whose center lies within half the thickness of the segment between the
  integer endpoints takes the color, the footprint of cv2's thick line
  (a filled quad of that half-width with round caps) to within a pixel;
- `write_png` writes an 8-bit RGB PNG with `zlib` and `struct` (one IDAT
  chunk, filter 0 on every row), and `read_png` reads such a file back.
The segments (`box_segments`: the same FACES edge walk, validity test,
integer endpoints and class colors as the JAX package's draw_detections)
and the colors are the JAX package's.
"""
from __future__ import annotations

import colorsys
import itertools
import struct
import zlib
from fractions import Fraction
from typing import List, Optional

import numpy as np

FACES = [
    [0, 1, 2, 3], [0, 3, 7, 4], [0, 4, 5, 1],
    [1, 2, 6, 5], [2, 6, 7, 3], [7, 4, 5, 6],
]
THICKNESS = 2


def _infinite_hues():
    yield Fraction(0)
    for k in itertools.count():
        i = 2 ** k
        for j in range(1, i, 2):
            yield Fraction(j, i)


def get_colors(n: int) -> List[tuple]:
    """Deterministic distinct colors (ref: parq_utils.py:119-138)."""
    def hsvs():
        for h in _infinite_hues():
            for s in [Fraction(6, 10)]:
                for v in [Fraction(6, 10), Fraction(9, 10)]:
                    yield (h, s, v)
    rgbs = (colorsys.hsv_to_rgb(*hsv) for hsv in hsvs())
    return [tuple(float(c) for c in rgb)
            for rgb in itertools.islice(rgbs, n)]


def _project(corners_c: np.ndarray, cam: np.ndarray):
    """(…, 8, 3) camera-frame corners → pixel coords + validity (host
    mirror of Camera.project)."""
    w, h, fx, fy, cx, cy = cam
    z = np.maximum(corners_c[..., 2], 1e-3)
    u = corners_c[..., 0] / z * fx + cx
    v = corners_c[..., 1] / z * fy + cy
    valid = ((corners_c[..., 2] > 1e-3) & (u >= 0) & (u <= w - 1)
             & (v >= 0) & (v <= h - 1))
    return np.stack([u, v], -1), valid


def _apply12(p: np.ndarray, pts: np.ndarray) -> np.ndarray:
    R = p[:9].reshape(3, 3)
    return pts @ R.T + p[9:]


def box_segments(cams: np.ndarray, box_corners_object: np.ndarray,
                 T_world_object: np.ndarray, T_pseudoCam_world: np.ndarray,
                 T_camera_pseudoCam: np.ndarray, labels: np.ndarray,
                 num_semcls: int, mask: Optional[np.ndarray] = None):
    """The wireframe segments of `draw_detections`, in its drawing order:
    [(view t, (x0, y0), (x1, y1), color)], integer pixel endpoints. A box
    is skipped when its label is num_semcls or negative or `mask` is off;
    an edge is drawn when both its corners project in front of the camera
    and inside the image."""
    id2color = get_colors(num_semcls)
    segs = []
    for t in range(cams.shape[0]):
        for n in range(box_corners_object.shape[0]):
            sem = int(labels[n])
            if sem == num_semcls or sem < 0:
                continue
            if mask is not None and not mask[n]:
                continue
            cw = _apply12(T_world_object[n], box_corners_object[n])
            cc = _apply12(T_camera_pseudoCam[t],
                          _apply12(T_pseudoCam_world[t], cw))
            uv, valid = _project(cc, cams[t])
            for face in FACES:
                for a, b in zip(face[:-1], face[1:]):
                    if valid[a] and valid[b]:
                        segs.append((t, tuple(uv[a].astype(int).tolist()),
                                     tuple(uv[b].astype(int).tolist()),
                                     id2color[sem]))
    return segs


def draw_segment(img: np.ndarray, p0, p1, color,
                 thickness: int = THICKNESS) -> None:
    """Color in place every pixel of `img` (H, W, C) whose center lies
    within thickness/2 of the segment p0–p1 (pixel coordinates x, y)."""
    r = thickness / 2.0
    (x0, y0), (x1, y1) = p0, p1
    H, W = img.shape[:2]
    xa, xb = max(int(np.floor(min(x0, x1) - r)), 0), \
        min(int(np.ceil(max(x0, x1) + r)), W - 1)
    ya, yb = max(int(np.floor(min(y0, y1) - r)), 0), \
        min(int(np.ceil(max(y0, y1) + r)), H - 1)
    if xa > xb or ya > yb:
        return
    ys, xs = np.mgrid[ya:yb + 1, xa:xb + 1]
    dx, dy = float(x1 - x0), float(y1 - y0)
    n2 = dx * dx + dy * dy
    t = (np.clip(((xs - x0) * dx + (ys - y0) * dy) / n2, 0.0, 1.0)
         if n2 > 0 else np.zeros(xs.shape))
    d2 = (xs - (x0 + t * dx)) ** 2 + (ys - (y0 + t * dy)) ** 2
    hit = d2 <= r * r
    img[ys[hit], xs[hit]] = color


def draw_detections(
    imgs: np.ndarray,              # (T, H, W, 3) float [0, 1]
    cams: np.ndarray,              # (T, 6)
    box_corners_object: np.ndarray,  # (N, 8, 3)
    T_world_object: np.ndarray,      # (N, 12) flat poses
    T_pseudoCam_world: np.ndarray,   # (T, 12)
    T_camera_pseudoCam: np.ndarray,  # (T, 12)
    labels: np.ndarray,              # (N,)
    num_semcls: int,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Wireframe overlays per view on each view normalized to [0, 1];
    returns the (T·H, W, 3) stack of the views (ref: parq_utils.py:141-211
    draws per-face edges with per-class color)."""
    views = [normalize_img(np.array(imgs[t])) for t in range(imgs.shape[0])]
    for t, p0, p1, color in box_segments(
            cams, box_corners_object, T_world_object, T_pseudoCam_world,
            T_camera_pseudoCam, labels, num_semcls, mask):
        draw_segment(views[t], p0, p1, color)
    return np.concatenate(views, axis=0)


def pca_compress(feat: np.ndarray) -> np.ndarray:
    """(H, W, C) → (H, W, 3) via PCA (ref: vis_utils.py:6-13)."""
    H, W, C = feat.shape
    x = feat.reshape(-1, C).astype(np.float64)
    x = x - x.mean(0, keepdims=True)
    _, _, Vt = np.linalg.svd(x, full_matrices=False)
    y = x @ Vt[:3].T
    return y.reshape(H, W, 3).astype(np.float32)


def normalize_img(img: np.ndarray) -> np.ndarray:
    return (img - img.min()) / max(img.max() - img.min(), 1e-6)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """A [0, 1] float image as 8 bits, as the JAX package's PNGs
    ((normalize_img(img) * 255).astype(np.uint8))."""
    return (normalize_img(img) * 255).astype(np.uint8)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    H, W, _ = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           img.reshape(H, W * 3)], axis=1)
    data = (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 image of a PNG that `write_png` wrote (8-bit
    RGB, filter 0); raises on anything else or a bad checksum."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad checksum in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    W, H, depth, color = header[:4]
    if (depth, color) != (8, 2):
        raise ValueError(f"{path}: bit depth {depth}, color type {color}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(H, 1 + 3 * W)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return rows[:, 1:].reshape(H, W, 3).copy()

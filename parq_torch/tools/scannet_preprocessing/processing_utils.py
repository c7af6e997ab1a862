"""Offline preprocessing utilities for ScanNet + scan2cad (the port's twin
of scripts/scannet_preprocessing/processing_utils.py; the same names).

Host numpy, as on the JAX side: TQS→matrix, box corners, the 9-class
RayTran category map, the difficulty levels and the four view-selection
strategies (including the train split's raw-frame-id overlap shifts ×10),
sequential over a scene's poses, with the JAX side's float64 arithmetic,
its NaN `arccos` behaviour and its thresholds verbatim.

The per-frame geometry runs on a device in float64, batched over F frames:
`depth_to_points` (homogeneous depth backprojection), `points_inside_corners`
(the edge-vector point-in-box test) and `fov_truncation_ratio` (corner
projection with the one-meter depth clamp). Beside each is its plain
per-frame version in numpy, written as the JAX side writes it
(`depth_to_point_cloud`, `points_inside_corners_plain`,
`fov_truncation_ratio_plain`): the tests hold the batched versions to them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# scan2cad alignment: translation / quaternion / scale → 4x4
# ---------------------------------------------------------------------------

def quat_to_matrix(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) quaternion → 3x3 rotation."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def tqs_to_matrix(t: Sequence[float], q: Sequence[float],
                  s: Sequence[float]) -> np.ndarray:
    """scan2cad trs record → 4x4 with per-axis scale folded into the
    rotation columns (ref: make_M_from_tqs, processing_utils.py:19-29)."""
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(q) @ np.diag(s)
    T[:3, 3] = np.asarray(t)
    return T


def make_corners(bbox: np.ndarray) -> np.ndarray:
    """(6,) [xmin,xmax,ymin,ymax,zmin,zmax] → (8, 3) reference ordering
    (ref: get_corner_by_dims, processing_utils.py:74-86 — corners 0-3 at
    zmin, 4-7 at zmax, x alternating -++-)."""
    x0, x1, y0, y1, z0, z1 = bbox
    return np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ])


# ---------------------------------------------------------------------------
# category mapping (9-class RayTran subset, ref: processing_utils.py:116-182)
# ---------------------------------------------------------------------------

CLASS_TO_INDEX_RAYTRAN = {
    "chair": 0, "table": 1, "cabinet": 2, "trashbin": 3, "bookshelf": 4,
    "display": 5, "sofa": 6, "bathtub": 7, "other": 8,
}

# scan2cad catid_cad (ShapeNet synset) → category name
CATID_TO_NAME = {
    "03211117": "display", "04379243": "table", "02808440": "bathtub",
    "02747177": "trashbin", "04256520": "sofa", "03001627": "chair",
    "02933112": "cabinet", "02871439": "bookshelf", "00000000": "other",
}


def catids_to_labels(catids: Sequence[str]) -> List[int]:
    """catid_cad list → RayTran class ids, unknowns → 'other'
    (ref: get_label + name2ids, processing_utils.py:185-204)."""
    return [CLASS_TO_INDEX_RAYTRAN[CATID_TO_NAME.get(str(c), "other")]
            for c in catids]


# ---------------------------------------------------------------------------
# depth → points, point-in-box, truncation: the plain per-frame versions, in
# numpy exactly as the JAX-side script writes them (the tests' reference)
# ---------------------------------------------------------------------------

def depth_to_point_cloud(depth: np.ndarray,
                         intrinsic_depth: np.ndarray) -> np.ndarray:
    """Depth map (H, W) in meters → (N, 3) camera-frame points with z > 0.

    Full resolution, homogeneous unprojection by the inverse 4x4 depth
    intrinsic — exactly the reference's construction
    (ref: get_point_cloud, processing_utils.py:132-154)."""
    h, w = depth.shape
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    pc = np.stack([xx * depth, yy * depth, depth, np.ones_like(depth)],
                  axis=2).reshape(-1, 4)
    pc = pc @ np.linalg.inv(intrinsic_depth).T
    return pc[pc[:, 2] > 0][:, :3]


def points_inside_corners_plain(corners: np.ndarray,
                                points: np.ndarray) -> np.ndarray:
    """Count points inside each box given its 8 corners.

    corners (K, 8, 3), points (N, 3), same frame. The edge-vector test from
    corner 4 along the box edges v45/v40/v47: 0 < (p-c4)·v < v·v
    (ref: get_point_cloud_inside_box3d, processing_utils.py:237-263).
    Returns int64 (K,)."""
    c4 = corners[:, 4]                              # (K, 3)
    edges = np.stack([corners[:, 5] - c4, corners[:, 0] - c4,
                      corners[:, 7] - c4], axis=1)  # (K, 3 edges, 3)
    rel = points[None, :, :] - c4[:, None, :]       # (K, N, 3)
    m = np.einsum("knj,kej->kne", rel, edges)       # (K, N, 3 edges)
    vv = np.einsum("kej,kej->ke", edges, edges)     # (K, 3 edges)
    inside = np.all((m > 0) & (m < vv[:, None, :]), axis=-1)
    return inside.sum(axis=-1)


def fov_truncation_ratio_plain(corners_camera: np.ndarray,
                               image_shape: Tuple[int, int],
                               intrinsic_color: np.ndarray) -> np.ndarray:
    """Visible-area ratio per box from camera-frame corners (K, 8, 3).

    Projects the 8 corners with the 4x4 color intrinsic, dividing by
    max(z, 1) — the reference's one-METER depth clamp, kept verbatim —
    takes the 2D AABB, and returns clipped-to-image area over
    max(raw area, 1). Higher = more visible
    (ref: get_box3d_inside_fov, processing_utils.py:206-234)."""
    h, w = image_shape[:2]
    K = corners_camera.shape[0]
    hom = np.concatenate([corners_camera, np.ones((K, 8, 1))], axis=-1)
    proj = hom @ intrinsic_color.T
    z = np.maximum(proj[..., 2], 1.0)
    u = proj[..., 0] / z
    v = proj[..., 1] / z
    xmin, xmax = u.min(-1), u.max(-1)
    ymin, ymax = v.min(-1), v.max(-1)
    area = (xmax - xmin) * (ymax - ymin)
    cx0, cx1 = np.clip(xmin, 0, w - 1), np.clip(xmax, 0, w - 1)
    cy0, cy1 = np.clip(ymin, 0, h - 1), np.clip(ymax, 0, h - 1)
    inside = (cx1 - cx0) * (cy1 - cy0)
    return inside / np.maximum(area, 1.0)


# ---------------------------------------------------------------------------
# the same three on a device, batched over F frames, in float64. Every dot
# product is written out as elementwise products summed in the plain
# version's order (no matmul: a GEMM may fuse or reorder them), and invalid
# depth is masked, not dropped (a boolean index is a host sync per frame).
# ---------------------------------------------------------------------------

def _rows(matrix: np.ndarray):
    """A 4x4 matrix's entries as Python floats (float32 values exactly)."""
    return [[float(v) for v in row] for row in np.asarray(matrix)]


def _affine(cols, row):
    """cols[0]*row[0] + cols[1]*row[1] + cols[2]*row[2] + row[3]: one row
    of a 4x4 transform applied to homogeneous (x, y, z, 1), summed left to
    right as `hom @ M.T` sums it."""
    return cols[0] * row[0] + cols[1] * row[1] + cols[2] * row[2] + row[3]


def depth_to_points(depth: torch.Tensor, intrinsic_depth: np.ndarray):
    """Depth maps (F, H, W) float32 in meters → camera-frame points
    (F, H·W, 3) float64 on depth's device, and `valid` (F, H·W): z > 0.

    The plain version's arithmetic: pixel index × depth in float64, then
    the inverse of the depth intrinsic (inverted by numpy in its own dtype,
    as the plain version inverts it)."""
    F, H, W = depth.shape
    inv = _rows(np.linalg.inv(intrinsic_depth))
    d = depth.to(torch.float64).reshape(F, H * W)
    xx = torch.arange(W, dtype=torch.float64, device=depth.device).repeat(H)
    yy = torch.arange(H, dtype=torch.float64,
                      device=depth.device).repeat_interleave(W)
    cols = (xx * d, yy * d, d)
    points = torch.stack([_affine(cols, inv[i]) for i in range(3)], -1)
    return points, points[..., 2] > 0


def points_inside_corners(corners: torch.Tensor, points: torch.Tensor,
                          valid: torch.Tensor,
                          budget_bytes: int = 1 << 30) -> torch.Tensor:
    """Count each frame's valid points inside each of its boxes.

    corners (F, K, 8, 3) and points (F, N, 3) float64 in one frame, valid
    (F, N) → int64 (F, K). The plain version's strict edge test,
    0 < (p - c4)·v < v·v along v45, v40 and v47. Boxes go in groups whose
    work buffers (42 bytes a point and box) stay within `budget_bytes`;
    each group reuses them (fresh host memory is slow to touch)."""
    F, K = corners.shape[:2]
    N = points.shape[1]
    c4 = corners[:, :, 4]                                       # (F, K, 3)
    edges = torch.stack([corners[:, :, 5] - c4, corners[:, :, 0] - c4,
                         corners[:, :, 7] - c4], 2)             # (F, K, 3, 3)
    vv = (edges[..., 0] * edges[..., 0] + edges[..., 1] * edges[..., 1]
          + edges[..., 2] * edges[..., 2])[..., None]           # (F, K, 3, 1)
    edges = edges[..., None]                                    # (F, K, 3, 3, 1)
    p = points.permute(2, 0, 1)[:, :, None, :]                  # (3, F, 1, N)
    counts = torch.empty(F, K, dtype=torch.int64, device=points.device)
    group = min(K, max(1, budget_bytes // max(1, 42 * F * N)))
    f64 = dict(dtype=torch.float64, device=points.device)
    rel = torch.empty(3, F, group, N, **f64)
    m, term = torch.empty(F, group, N, **f64), torch.empty(F, group, N, **f64)
    inside = torch.empty(F, group, N, dtype=torch.bool, device=points.device)
    test = torch.empty_like(inside)
    for k0 in range(0, K, group):
        k = min(group, K - k0)
        ks = slice(k0, k0 + k)
        r, mk, tk, ik, sk = rel[:, :, :k], m[:, :k], term[:, :k], \
            inside[:, :k], test[:, :k]
        for j in range(3):
            torch.sub(p[j], c4[:, ks, j, None], out=r[j])       # (F, k, N)
        ik.copy_(valid[:, None, :].expand(F, k, N))
        for e in range(3):
            v = edges[:, ks, e]                                 # (F, k, 3, 1)
            torch.mul(r[0], v[:, :, 0], out=mk)
            torch.mul(r[1], v[:, :, 1], out=tk)
            mk += tk
            torch.mul(r[2], v[:, :, 2], out=tk)
            mk += tk
            ik &= torch.gt(mk, 0, out=sk)
            ik &= torch.lt(mk, vv[:, ks, e], out=sk)
        counts[:, ks] = ik.sum(-1)
    return counts


def fov_truncation_ratio(corners_camera: torch.Tensor,
                         image_shape: Tuple[int, int],
                         intrinsic_color: np.ndarray) -> torch.Tensor:
    """Visible-area ratio (F, K) of camera-frame corners (F, K, 8, 3)
    float64: the plain version batched, the one-meter depth clamp
    max(z, 1) kept."""
    h, w = image_shape[:2]
    k = _rows(intrinsic_color)
    cols = corners_camera.unbind(-1)
    u, v, z = (_affine(cols, k[i]) for i in range(3))
    z = z.clamp(min=1.0)
    u, v = u / z, v / z
    xmin, xmax = u.amin(-1), u.amax(-1)
    ymin, ymax = v.amin(-1), v.amax(-1)
    area = (xmax - xmin) * (ymax - ymin)
    cx0, cx1 = xmin.clamp(0, w - 1), xmax.clamp(0, w - 1)
    cy0, cy1 = ymin.clamp(0, h - 1), ymax.clamp(0, h - 1)
    inside = (cx1 - cx0) * (cy1 - cy0)
    return inside / area.clamp(min=1.0)


def get_level(num_points_inside: float, trunc_ratio: float) -> int:
    """Difficulty 0 (easy) … 3 (drop). trunc_ratio is the VISIBLE fraction
    (higher is better). Thresholds verbatim from the reference
    (ref: get_level, processing_utils.py:304-336)."""
    if num_points_inside > 1000 and trunc_ratio > 0.85:
        return 0
    if num_points_inside > 500 and trunc_ratio > 0.70:
        return 1
    if num_points_inside > 100 and trunc_ratio > 0.50:
        return 2
    return 3


# ---------------------------------------------------------------------------
# view selection (ref: processing_utils.py:352-505). All four strategies
# share the motion test: the angle between the two frames' VIEWING
# DIRECTIONS — arccos of the z component of R_cur^T R_last z — or the
# translation distance, strictly greater than the thresholds. NaN angles
# (numerical arccos overflow) fail the test, as in the reference.
# ---------------------------------------------------------------------------

def _moved(cur: np.ndarray, last: np.ndarray, min_angle: float,
           min_distance: float) -> bool:
    z = np.array([0.0, 0.0, 1.0])
    cos = (cur[:3, :3].T @ last[:3, :3] @ z)[2]
    with np.errstate(invalid="ignore"):
        angle = np.arccos(cos)
    dis = np.linalg.norm(cur[:3, 3] - last[:3, 3])
    return bool(angle > np.radians(min_angle)) or bool(dis > min_distance)


def select_keyframes(pose_dict: Dict[int, np.ndarray],
                     min_angle: float = 15.0,
                     min_distance: float = 0.1) -> List[int]:
    """First frame unconditional, then keep every frame that moved vs the
    last KEPT frame (ref: the shared selection loop of view_selection_w1 /
    _overlap / _allframes, processing_utils.py:386-419)."""
    kept: List[int] = []
    last = None
    for fid, pose in pose_dict.items():
        if last is None or _moved(pose, last, min_angle, min_distance):
            kept.append(fid)
            last = pose
    return kept


def view_selection_val(pose_dict: Dict[int, np.ndarray], window: int = 3,
                       min_angle: float = 15.0,
                       min_distance: float = 0.1) -> List[List[int]]:
    """Val split: windows accumulate DURING selection — after a window
    completes the state resets, so the next frame starts the next window
    unconditionally; an unfinished tail window is dropped
    (ref: view_selection, processing_utils.py:352-384)."""
    out: List[List[int]] = []
    cur: List[int] = []
    last = None
    for fid, pose in pose_dict.items():
        if not cur:
            cur.append(fid)
            last = pose
        elif _moved(pose, last, min_angle, min_distance):
            cur.append(fid)
            last = pose
            if len(cur) == window:
                out.append(cur)
                cur = []
                last = None
    return out


def view_selection_w1(pose_dict: Dict[int, np.ndarray],
                      min_angle: float = 15.0,
                      min_distance: float = 0.1) -> List[List[int]]:
    """Single-frame snippets of every keyframe
    (ref: view_selection_w1, processing_utils.py:386-418)."""
    return [[k] for k in select_keyframes(pose_dict, min_angle,
                                          min_distance)]


def view_selection_overlap(pose_dict: Dict[int, np.ndarray],
                           window: int = 3, min_angle: float = 15.0,
                           min_distance: float = 0.1) -> List[List[int]]:
    """Train split: keyframe windows duplicated at RAW-frame-id shifts
    +0..+9. A shifted window is kept only when its last id stays within
    the scene and every shifted id has a pose; duplicates are removed
    preserving first-occurrence order
    (ref: view_selection_overlap, processing_utils.py:421-466)."""
    ids = select_keyframes(pose_dict, min_angle, min_distance)
    if not pose_dict:
        return []
    last_id = list(pose_dict.keys())[-1]
    out: List[List[int]] = []
    for i in range(10):
        for j in range(len(ids)):
            if j + window <= len(ids):
                win = ids[j:j + window]
                if win[-1] + i <= last_id:
                    shifted = [f + i for f in win if f + i in pose_dict]
                    if len(shifted) == window and shifted not in out:
                        out.append(shifted)
    return out


def view_selection_allframes(pose_dict: Dict[int, np.ndarray],
                             min_angle: float = 15.0,
                             min_distance: float = 0.1) -> List[List[int]]:
    """One snippet holding every keyframe
    (ref: view_selection_allframes, processing_utils.py:469-505)."""
    return [select_keyframes(pose_dict, min_angle, min_distance)]


def view_selection(pose_dict: Dict[int, np.ndarray], window: int = 3,
                   variant: str = "overlap", min_angle: float = 15.0,
                   min_distance: float = 0.1) -> List[List[int]]:
    """Dispatch over the four reference strategies. 'overlap' = train,
    'nonoverlap' = val, plus 'w1' and 'allframes'
    (ref: save_snippet_pkl dispatch,
    generate_scannet_anno_snippet.py:146-158)."""
    if variant == "overlap":
        return view_selection_overlap(pose_dict, window, min_angle,
                                      min_distance)
    if variant == "nonoverlap":
        if window == 1:
            return view_selection_w1(pose_dict, min_angle, min_distance)
        return view_selection_val(pose_dict, window, min_angle, min_distance)
    if variant == "w1":
        return view_selection_w1(pose_dict, min_angle, min_distance)
    if variant == "allframes":
        return view_selection_allframes(pose_dict, min_angle, min_distance)
    raise ValueError(variant)

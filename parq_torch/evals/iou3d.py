"""3D box IoU via BEV convex polygon clipping, on the host (numpy copy of
parq_tpu/evals/iou3d.py with two repairs for boxes that share edges, such
as one GT box seen in two snippets: a point on a clip line counts as
inside, and a subject edge parallel to the clip edge it crosses yields its
end. The JAX package's IoU of a rotated box with itself is NaN or wrong
for most boxes; ROADMAP §C).

Re-derivation of ref utils/f1_eval.py:65-175 (ODAM-derived) without numba or
scipy.spatial: the Sutherland–Hodgman intersection of two convex quads is an
ordered convex polygon, so its area is a direct shoelace sum (the reference
routes it through qhull's ConvexHull, same value). Corner convention is
identical: boxes come as the reference's 8-corner ordering; callers apply the
[4,0,1,5,7,3,2,6] + rotx(pi/2) reorder to reach the neg-Y-up convention.
"""
from __future__ import annotations

import numpy as np

# corner reorder applied before iou (ref: f1_eval.py:56-58).
# Convention: object frames are y-up (scan2cad CAD models), the world is
# z-up, so world corners carry an embedded rotx(+90°); applying rotx(+90°)
# again lands in a frame where up = −Y and the reordered corners 0-3 / 4-7
# are the two horizontal faces (hence "assume up direction is negative Y").
ODAM_REORDER = np.array([4, 0, 1, 5, 7, 3, 2, 6])
ROTX90 = np.array([[1.0, 0.0, 0.0],
                   [0.0, 0.0, -1.0],
                   [0.0, 1.0, 0.0]])


def to_odam(corners: np.ndarray) -> np.ndarray:
    """(…, 8, 3) reference-ordered corners → neg-Y-up ODAM convention."""
    return corners[..., ODAM_REORDER, :] @ ROTX90.T


def poly_area(x: np.ndarray, y: np.ndarray) -> float:
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygon_clip(subject, clip):
    """Sutherland–Hodgman; both polygons lists of (x, y), clip convex,
    counter-clockwise (ref: f1_eval.py:132-175). Returns vertices or None."""

    def inside(p, cp1, cp2):
        # on the clip line counts as inside (the JAX package's strict test
        # drops the shared edges of coincident boxes: ROADMAP §C)
        return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) >= \
               (cp2[1] - cp1[1]) * (p[0] - cp1[0])

    def intersection(cp1, cp2, s, e, on_line):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        det = dc[0] * dp[1] - dc[1] * dp[0]
        if det == 0.0:
            # s→e runs along the clip line (rounding put one end outside):
            # the crossing is that end. The JAX package divides by zero
            # here and its IoU is NaN (ROADMAP §C).
            return on_line
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        n3 = 1.0 / det
        return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)

    output = list(subject)
    cp1 = clip[-1]
    for cp2 in clip:
        inputs = output
        output = []
        if not inputs:
            return None
        s = inputs[-1]
        for e in inputs:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output.append(intersection(cp1, cp2, s, e, s))
                output.append(e)
            elif inside(s, cp1, cp2):
                output.append(intersection(cp1, cp2, s, e, e))
            s = e
        cp1 = cp2
        if not output:
            return None
    return output


def convex_hull_intersection(p1, p2):
    inter = polygon_clip(p1, p2)
    if inter is None or len(inter) < 3:
        return None, 0.0
    xs = np.array([p[0] for p in inter])
    ys = np.array([p[1] for p in inter])
    return inter, poly_area(xs, ys)


def box3d_vol(corners: np.ndarray) -> float:
    a = np.sqrt(np.sum((corners[0] - corners[1]) ** 2))
    b = np.sqrt(np.sum((corners[1] - corners[2]) ** 2))
    c = np.sqrt(np.sum((corners[0] - corners[4]) ** 2))
    return a * b * c


def iou3d(corners1: np.ndarray, corners2: np.ndarray):
    """(8,3) ODAM-convention corners (up = −Y) → (iou3d, iou_bev)
    (ref: f1_eval.py:77-106)."""
    if np.isnan(corners1).any() or np.isnan(corners2).any():
        return 0.0, 0.0
    try:
        rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
        rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
        area1 = poly_area(np.array([p[0] for p in rect1]),
                          np.array([p[1] for p in rect1]))
        area2 = poly_area(np.array([p[0] for p in rect2]),
                          np.array([p[1] for p in rect2]))
        _, inter_area = convex_hull_intersection(rect1, rect2)
        iou_2d = inter_area / (area1 + area2 - inter_area)
        ymax = min(corners1[0, 1], corners2[0, 1])
        ymin = max(corners1[4, 1], corners2[4, 1])
        inter_vol = inter_area * max(0.0, ymax - ymin)
        vol1 = box3d_vol(corners1)
        vol2 = box3d_vol(corners2)
        iou = inter_vol / (vol1 + vol2 - inter_vol)
    except (ZeroDivisionError, FloatingPointError):
        return 0.0, 0.0
    return float(iou), float(iou_2d)

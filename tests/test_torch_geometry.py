"""parq_torch geometry, posemb, rays and grid sampling against the JAX
package on the same seeded numpy inputs (f32, atol 1e-5)."""
import numpy as np
import jax.numpy as jnp
import torch

from parq_tpu import geometry as jg
from parq_tpu.evals.nms import run_nms as j_run_nms
from parq_tpu.evals.parse_pred import parse_pred_device as j_parse_device
from parq_tpu.ops.grid_sample import grid_sample_bilinear as j_grid_sample
from parq_tpu.ops.posemb import pos2posemb3d as j_posemb

from parq_torch import geometry as tg
from parq_torch.evals.nms import run_nms as t_run_nms
from parq_torch.evals.parse_pred import parse_pred_device as t_parse_device
from parq_torch.ops.grid_sample import grid_sample_bilinear as t_grid_sample
from parq_torch.ops.posemb import pos2posemb3d as t_posemb

import torch_common  # noqa: F401

ATOL = 1e-5


def _poses(rng, shape):
    """Random proper rotations (QR) + translations, flat (..., 12)."""
    n = int(np.prod(shape))
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    t = rng.randn(n, 3)
    return np.concatenate([q.reshape(n, 9), t], -1).reshape(
        shape + (12,)).astype(np.float32)


def _close(t_val, j_val, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), atol=atol,
                               rtol=rtol)


def test_pose_algebra(rng):
    a, b = _poses(rng, (2, 3)), _poses(rng, (2, 3))
    pts = rng.randn(2, 3, 5, 3).astype(np.float32)
    ja, jb = jg.Pose(jnp.asarray(a)), jg.Pose(jnp.asarray(b))
    ta, tb = tg.Pose(torch.from_numpy(a)), tg.Pose(torch.from_numpy(b))
    _close(ta.inverse().data, ja.inverse().data)
    _close((ta @ tb).data, (ja @ jb).data)
    _close(ta.transform(torch.from_numpy(pts)),
           ja.transform(jnp.asarray(pts)))


def test_camera_project_scale_unproject(rng):
    cam = np.tile(np.array([64, 48, 50, 52, 31.5, 24.2], np.float32),
                  (2, 3, 1))
    # points in front, off-image and behind the camera
    p = rng.randn(2, 3, 20, 3).astype(np.float32) * [1.5, 1.0, 2.0]
    jc, tc = jg.Camera(jnp.asarray(cam)), tg.Camera(torch.from_numpy(cam))
    j2d, jv = jc.project(jnp.asarray(p))
    t2d, tv = tc.project(torch.from_numpy(p))
    # behind the camera |uv| reaches ~1e5, where one f32 ulp is ~1e-2
    _close(t2d, j2d, rtol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any() and not tv.all()
    _close(tc.scale(0.25).data, jc.scale(0.25).data)
    uv = rng.rand(2, 3, 7, 2).astype(np.float32) * 40
    _close(tc.unproject(torch.from_numpy(uv)), jc.unproject(jnp.asarray(uv)))


def test_ray_dirs_snippet_and_depths(rng):
    cam = np.tile(np.array([16, 12, 10, 11, 7.5, 5.5], np.float32),
                  (2, 3, 1))
    tcp, twp = _poses(rng, (2, 3)), _poses(rng, (2, 3))
    tlw = _poses(rng, (2, 1))
    jr, jt = jg.ray_dirs_snippet(
        jg.grid_2d(16, 12), jg.Camera(jnp.asarray(cam)),
        jg.Pose(jnp.asarray(tcp)), jg.Pose(jnp.asarray(twp)),
        jg.Pose(jnp.asarray(tlw)))
    tr, tt = tg.ray_dirs_snippet(
        tg.grid_2d(16, 12), tg.Camera(torch.from_numpy(cam)),
        tg.Pose(torch.from_numpy(tcp)), tg.Pose(torch.from_numpy(twp)),
        tg.Pose(torch.from_numpy(tlw)))
    _close(tr, jr)
    _close(tt, jt)
    _close(tg.depth_planes(64, 0.25, 5.25), jg.depth_planes(64, 0.25, 5.25))
    x = rng.rand(50).astype(np.float32) * 1.4 - 0.2
    _close(tg.inverse_sigmoid(torch.from_numpy(x)),
           jg.inverse_sigmoid(jnp.asarray(x)))


def test_posemb_and_rotation(rng):
    pos = rng.rand(2, 7, 3).astype(np.float32)
    _close(t_posemb(torch.from_numpy(pos)), j_posemb(jnp.asarray(pos)))
    o6 = rng.randn(2, 7, 6).astype(np.float32)
    _close(tg.rotation_matrix_from_ortho6d(torch.from_numpy(o6)),
           jg.rotation_matrix_from_ortho6d(jnp.asarray(o6)))


def test_grid_sample_matches_jax_and_torch(rng):
    feats = rng.randn(3, 5, 7, 8).astype(np.float32)
    grid = (rng.rand(3, 11, 2).astype(np.float32) * 2.6 - 1.3)
    got = t_grid_sample(torch.from_numpy(feats), torch.from_numpy(grid))
    _close(got, j_grid_sample(jnp.asarray(feats), jnp.asarray(grid)))
    want = torch.nn.functional.grid_sample(
        torch.from_numpy(feats).permute(0, 3, 1, 2),
        torch.from_numpy(grid)[:, None], mode="bilinear",
        padding_mode="zeros", align_corners=True)[:, :, 0].transpose(1, 2)
    _close(got, want.numpy())


def test_parse_pred_device_matches_jax(rng):
    B, K = 2, 5
    last = {
        "size_unnormalized": rng.rand(B, K, 3).astype(np.float32) + 0.2,
        "center_unnormalized": rng.randn(B, K, 3).astype(np.float32),
        "sem_cls_prob": rng.dirichlet(np.ones(10), (B, K)).astype(
            np.float32),
        "ortho6d": rng.randn(B, K, 6).astype(np.float32),
    }
    twl = _poses(rng, (B, 1))
    ts = (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0)
    want = j_parse_device({k: jnp.asarray(v) for k, v in last.items()},
                          jnp.asarray(twl), ts)
    got = t_parse_device({k: torch.from_numpy(v) for k, v in last.items()},
                         torch.from_numpy(twl), ts)
    for k in ("obb_data", "corners_local", "corners_world", "scores"):
        _close(got[k], want[k])
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_nms_matches_jax(rng):
    """Clustered boxes so the greedy pass really suppresses; background
    boxes (label == num_semcls) are never kept."""
    B, K, ncls = 2, 40, 9
    centers = rng.randn(B, K, 1, 3) * 0.4 + rng.randint(0, 3, (B, K, 1, 1))
    corners = centers + rng.rand(B, K, 8, 3) * 0.6
    labels = rng.randint(0, ncls + 1, (B, K))
    scores = rng.rand(B, K)
    want = j_run_nms(corners, labels, scores, ncls, 0.1)
    got = t_run_nms(corners, labels, scores, ncls, 0.1)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < (labels != ncls).sum()

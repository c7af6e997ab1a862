"""The port's vis utilities (parq_torch/utils/vis.py) against the JAX
package's (parq_tpu/utils/vis.py, which draws with cv2 and writes PNGs with
PIL), and their use in the port's Trainer and eval twin, on the CPU:

- `get_colors` equal; `_project` uv and validity equal on random boxes and
  cameras;
- the segments drawn equal, edge for edge (cv2.line's calls recorded);
- the raster against cv2's thick line, box by box: every pixel the port
  draws lies within 1 px (8-neighbourhood) of one cv2 draws, and the other
  way round, and every drawn pixel has the box's class color in both;
- `pca_compress` against JAX's, up to each component's sign;
- the PNG writer: PIL decodes its file to the same array, bit for bit;
- `Trainer.validate(for_vis=True)` writes one PNG a batch (the port's twin
  of tests/test_demo_vis.py), `log_images` writes the prediction, GT and
  feature-map PNGs, the eval twin with FOR_VIS writes demo_vis/ (on
  synthetic snippets and, with --DEMO, on fake ARKit fragments), and a
  vis failure raises.
"""
import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

from parq_tpu.utils import vis as jvis

from parq_torch.config import get_cfg, update_config
from parq_torch.utils import vis

from torch_common import rand_pose, save_jpg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_SEMCLS = 9
W, H = 96, 72


def _scene(rng, n_boxes=12, views=3):
    """Random boxes 1-5 m in front of `views` cameras, some partly out of
    view, random yaw; labels with pads (-1) and the no-object class; a
    random mask."""
    cams = np.tile(np.array([W, H, 60.0, 60.0, W / 2, H / 2]), (views, 1))
    cams[:, 2:4] += rng.uniform(-10, 10, (views, 2))
    size = rng.uniform(0.2, 1.5, (n_boxes, 3))
    lo, hi = -size / 2, size / 2
    signs = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
    corners = lo[:, None] + (hi - lo)[:, None] * signs
    yaw = rng.uniform(-np.pi, np.pi, n_boxes)
    R = np.zeros((n_boxes, 3, 3))
    R[:, 0, 0], R[:, 0, 2] = np.cos(yaw), np.sin(yaw)
    R[:, 1, 1] = 1.0
    R[:, 2, 0], R[:, 2, 2] = -np.sin(yaw), np.cos(yaw)
    t = np.stack([rng.uniform(-1.5, 1.5, n_boxes),
                  rng.uniform(-1.0, 1.0, n_boxes),
                  rng.uniform(0.5, 5.0, n_boxes)], -1)
    T_world_object = np.concatenate([R.reshape(n_boxes, 9), t], -1)

    def pose(shift):
        return np.concatenate([np.eye(3).reshape(9), shift])
    T_pw = np.stack([pose(rng.uniform(-0.2, 0.2, 3)) for _ in range(views)])
    T_cp = np.stack([pose(np.zeros(3)) for _ in range(views)])
    labels = rng.randint(-1, NUM_SEMCLS + 1, n_boxes)
    mask = rng.rand(n_boxes) > 0.2
    return cams, corners, T_world_object, T_pw, T_cp, labels, mask


def test_get_colors_equal():
    for n in (1, 9, 18, 40):
        assert vis.get_colors(n) == jvis.get_colors(n)


def test_project_equal(rng):
    pts = rng.uniform(-3, 3, (50, 8, 3))
    pts[..., 2] = rng.uniform(-0.5, 5, (50, 8))
    for cam in ([W, H, 60.0, 55.0, 48.0, 36.0], [320, 240, 256, 256, 160,
                                                  120]):
        uv, valid = vis._project(pts, np.asarray(cam))
        juv, jvalid = jvis._project(pts, np.asarray(cam))
        np.testing.assert_array_equal(uv, juv)
        np.testing.assert_array_equal(valid, jvalid)
        assert 0 < valid.mean() < 1


def _cv2_draws(monkeypatch, imgs, scene):
    """JAX's draw_detections with cv2.line's calls recorded:
    (image, [(view, p0, p1, color)])."""
    import cv2
    calls, views = [], []
    line = cv2.line

    def record(img, p0, p1, color, thickness):
        # each view is drawn on a fresh array: tell them by their buffers
        ptr = img.__array_interface__["data"][0]
        if ptr not in views:
            views.append(ptr)
        calls.append((views.index(ptr), tuple(p0), tuple(p1), tuple(color)))
        assert thickness == vis.THICKNESS
        return line(img, p0, p1, color, thickness=thickness)

    monkeypatch.setattr(cv2, "line", record)
    out = jvis.draw_detections(imgs, *scene[:5], scene[5], NUM_SEMCLS,
                               mask=scene[6])
    monkeypatch.undo()
    return out, calls


def test_segments_equal_edge_for_edge(rng, monkeypatch):
    scene = _scene(rng)
    imgs = rng.rand(3, H, W, 3).astype(np.float32)
    _, calls = _cv2_draws(monkeypatch, imgs, scene)
    segs = vis.box_segments(*scene[:5], scene[5], NUM_SEMCLS, mask=scene[6])
    assert len(segs) > 20
    # cv2 draws on views in order; a view without segments is not seen
    views = sorted({s[0] for s in segs})
    remap = {i: v for i, v in enumerate(views)}
    assert [(remap[c[0]],) + c[1:] for c in calls] == segs


def test_raster_within_one_pixel_of_cv2(rng, monkeypatch):
    """Box by box on a black image (normalize leaves it 0): drawn = any
    channel non-zero."""
    scene = _scene(rng, n_boxes=16)
    cams, corners, Two, T_pw, T_cp, labels, _ = scene
    imgs = np.zeros((3, H, W, 3), np.float32)
    colors = vis.get_colors(NUM_SEMCLS)
    checked = 0
    for n in range(corners.shape[0]):
        if not 0 <= labels[n] < NUM_SEMCLS:
            continue
        one = (cams, corners[n:n + 1], Two[n:n + 1], T_pw, T_cp,
               labels[n:n + 1], None)
        want, _ = _cv2_draws(monkeypatch, imgs, one)
        got = vis.draw_detections(imgs, *one[:6], NUM_SEMCLS)
        a, b = got.any(-1), want.any(-1)
        if not b.any():
            assert not a.any()
            continue
        checked += 1

        def near(m):               # 3x3 dilation
            p = np.pad(m, 1)
            return np.any([p[1 + dy:1 + dy + m.shape[0],
                             1 + dx:1 + dx + m.shape[1]]
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
        assert not (a & ~near(b)).any(), n
        assert not (b & ~near(a)).any(), n
        c = np.asarray(colors[labels[n]], np.float32)
        assert (got[a] == c).all() and (want[b] == c).all(), n
        # and they are mostly the same pixels
        assert (a & b).sum() >= 0.8 * max(a.sum(), b.sum()), n
    assert checked >= 5


def test_pca_compress_matches_jax_up_to_sign(rng):
    feat = rng.randn(12, 16, 32).astype(np.float32)
    got, want = vis.pca_compress(feat), jvis.pca_compress(feat)
    for k in range(3):
        g, w = got[..., k], want[..., k]
        s = np.sign((g * w).sum())
        np.testing.assert_allclose(g, s * w, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(vis.normalize_img(feat),
                                  jvis.normalize_img(feat))


@pytest.mark.parametrize("shape", [(1, 1), (72, 96), (720, 320)])
def test_png_writer_decodes_bit_for_bit(rng, tmp_path, shape):
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    vis.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(vis.read_png(path), img)
    with pytest.raises(ValueError):
        vis.write_png(path, img.astype(np.float32))


# ---- the Trainer and the eval twin ---------------------------------------
def _smoke_cfg(*opts):
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"),
        opts=["TPU.PLATFORM", "cpu", *opts]))
    return cfg


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    from parq_torch.train.loop import Trainer
    cfg = _smoke_cfg("MODEL.DECODER.FOR_VIS", "True", "LOG_IMAGES", "True")
    t = Trainer(cfg, workdir=str(tmp_path_factory.mktemp("work")))
    t.setup_state(steps_per_epoch=1)
    return t


def _loader(n=2):
    from parq_torch.data import SnippetLoader, SyntheticDataset
    ds = SyntheticDataset(num_snippets=n, image_size=(64, 48), seed=5)
    return SnippetLoader(ds, batch_size=1, shuffle=False, drop_last=False)


def test_validate_for_vis_writes_one_png_a_batch(trainer, tmp_path):
    vis_dir = str(tmp_path / "demo_vis")
    metrics = trainer.validate(_loader(2), for_vis=True, vis_dir=vis_dir)
    pngs = sorted(os.listdir(vis_dir))
    assert pngs == ["synthetic_scene_000_5_rgb_imgwithbox.png",
                    "synthetic_scene_001_6_rgb_imgwithbox.png"]
    for p in pngs:
        img = np.asarray(Image.open(os.path.join(vis_dir, p)))
        assert img.shape == (3 * 48, 64, 3) and img.dtype == np.uint8
    assert "total_loss" in metrics
    # a standalone validation logs no images (the JAX Trainer's writer
    # does not exist yet)
    assert not os.path.exists(os.path.join(trainer.workdir, "images"))


def test_log_images_writes_overlays_and_pca(trainer):
    from parq_torch.train.loop import to_device_batch
    batch = next(iter(_loader(1)))
    dev = to_device_batch(batch, "cpu")
    with torch.no_grad():
        outputs, feat = trainer.model(dev, deterministic=True,
                                      return_feature_map=True)
    paths = trainer.log_images(batch, outputs, "train", feat)
    assert [os.path.basename(p) for p in paths] == [
        "train_rgb_imgwithbox_0.png", "train_gt_imgwithbox_0.png",
        "train_feature_map_0.png"]
    shapes = [vis.read_png(p).shape for p in paths]
    fh, fw = feat.shape[2:4]
    assert shapes == [(3 * 48, 64, 3), (3 * 48, 64, 3), (3 * fh, fw, 3)]
    gt = trainer._render_gt_boxes(batch)
    np.testing.assert_array_equal(vis.read_png(paths[1]), vis.to_uint8(gt))
    plain = np.concatenate([vis.normalize_img(v)
                            for v in batch["rgb_img"][0]], axis=0)
    assert (gt != plain).any(-1).sum() > 20   # the GT wireframes are drawn


def test_vis_failure_raises(trainer, tmp_path, monkeypatch):
    def broken(path, img):
        raise OSError("disk full")
    monkeypatch.setattr(vis, "write_png", broken)
    with pytest.raises(OSError, match="disk full"):
        trainer.validate(_loader(1), for_vis=True,
                         vis_dir=str(tmp_path / "v"))


def test_eval_twin_for_vis_writes_demo_vis(tmp_path, monkeypatch):
    from parq_torch.cli import eval as cli_eval
    monkeypatch.chdir(tmp_path)
    metrics = cli_eval.main([
        "--cfg", os.path.join(ROOT, "configs", "smoke.yaml"), "TPU.PLATFORM",
        "cpu", "DATAMODULE.DATA_PATH", "synthetic", "MODEL.DECODER.FOR_VIS",
        "True", "DATAMODULE.BATCH_SIZE", "4", "LOG_PATH",
        str(tmp_path / "logs")])
    pngs = sorted(os.listdir(tmp_path / "demo_vis"))
    assert len(pngs) == 2 and all(p.endswith("_rgb_imgwithbox.png")
                                  for p in pngs)
    assert "mean_latency_s" in metrics


def test_eval_twin_demo_writes_demo_vis(tmp_path, monkeypatch):
    """`--DEMO` on two fake ARKit fragments (the layout of
    tests/test_torch_data.py::test_demo_items_equal_jax): no ground truth,
    one overlay PNG a fragment in demo_vis/."""
    import pickle
    from parq_torch.cli import eval as cli_eval
    rng = np.random.RandomState(1)
    scene = "2023-03-03T19-23-25"
    (tmp_path / scene / "images").mkdir(parents=True)
    frags = []
    for frag in range(2):
        ids = [10 * frag + k for k in range(3)]
        for i in ids:
            save_jpg(rng, tmp_path / scene / "images" / f"{i}.jpg")
        frags.append({"scene": scene, "fragment_id": frag, "image_ids": ids,
                      "extrinsics": np.stack([rand_pose(rng) for _ in ids]),
                      "intrinsics": [np.array([[50.0, 0, 32], [0, 50.0, 24],
                                               [0, 0, 1.0]])] * 3})
    gt = tmp_path / scene / "fragments.pkl"
    with open(gt, "wb") as f:
        pickle.dump(frags, f)
    monkeypatch.chdir(tmp_path)
    cli_eval.main([
        "--cfg", os.path.join(ROOT, "configs", "smoke.yaml"), "--DEMO",
        "True", "TPU.PLATFORM", "cpu", "DATAMODULE.DATA_PATH", str(tmp_path),
        "DATAMODULE.VAL_ANNOTATION_PATH", str(gt), "MODEL.DECODER.FOR_VIS",
        "True", "DATAMODULE.BATCH_SIZE", "1", "LOG_PATH",
        str(tmp_path / "logs")])
    pngs = sorted(os.listdir(tmp_path / "demo_vis"))
    assert pngs == [f"{scene}_{i}_rgb_imgwithbox.png" for i in range(2)]
    assert vis.read_png(str(tmp_path / "demo_vis" / pngs[0])).shape == \
        (3 * 48, 64, 3)

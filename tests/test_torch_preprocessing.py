"""The port's offline ScanNet preprocessing
(`parq_torch.tools.scannet_preprocessing`) against
scripts/scannet_preprocessing, on the CPU.

Each case of tests/test_preprocessing.py runs both toolchains on the same
inputs (counts and ids equal, float64 values to 1e-12); the PIL-free
readers match PIL on files PIL writes and on PNGs filtered by hand; on a
seeded random layout (noisy depth with zeros, 12 rotated boxes, a PNG
depth fallback and a missing depth frame) every pickle of every view
selection variant equals the JAX side's once loaded, and the scan2cad
pickles byte for byte; the port's pickles feed both loaders.
"""
import ast
import contextlib
import io
import json
import os
import pickle
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from test_preprocessing import (GEN, PU, _dense_poses, _make_scene, _pose,
                                _scan2cad_json, _sparse_poses,
                                parse_scan2cad)

import chip_smoke
from parq_torch.tools.scannet_preprocessing import (
    generate_scannet_anno_snippet as PGEN, image_io,
    parse_scan2cad as PPARSE, processing_utils as PPU)

import torch_common  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "parq_torch" / "tools" / "scannet_preprocessing"
SCENES = ("scene0000_00", "scene0001_00")


def _same_tree(a, b):
    """Loaded pickles equal: containers item by item, arrays by dtype and
    value (float arrays to 1e-12), everything else by type and value."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        if not (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape):
            return False
        if a.dtype.kind == "f":
            return np.allclose(a, b, rtol=1e-12, atol=1e-12)
        return np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# (a) the cases of tests/test_preprocessing.py, both toolchains
# ---------------------------------------------------------------------------

def test_moved_translation_threshold():
    a = _pose(0.0)
    for b, want in ((_pose(0.05), False), (_pose(0.15), True)):
        assert PPU._moved(b, a, 15.0, 0.1) is PU._moved(b, a, 15.0, 0.1) \
            is want


def test_moved_is_viewing_direction_not_full_rotation():
    base = _pose(0.0)
    c, s = np.cos(np.radians(40)), np.sin(np.radians(40))
    roll = base[:3, :3] @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    c, s = np.cos(np.radians(20)), np.sin(np.radians(20))
    pitch = base[:3, :3] @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    for R, want in ((roll, False), (pitch, True)):
        cur = _pose(0.0, R=R)
        assert PPU._moved(cur, base, 15.0, 0.1) is \
            PU._moved(cur, base, 15.0, 0.1) is want


def _same_windows(poses, want, **kw):
    got = PPU.view_selection(poses, **kw)
    assert got == PU.view_selection(poses, **kw) == want
    return got


def test_val_windows_dense():
    _same_windows(_dense_poses(10), [[0, 1, 2], [3, 4, 5], [6, 7, 8]],
                  window=3, variant="nonoverlap")


def test_val_windows_coupled_reset():
    _same_windows(_sparse_poses(), [[0, 3, 6]], window=3,
                  variant="nonoverlap")


def test_overlap_windows_dense_dedup():
    _same_windows(_dense_poses(10), [[j, j + 1, j + 2] for j in range(8)],
                  window=3, variant="overlap")


def test_overlap_windows_sparse_shifts():
    _same_windows(_sparse_poses(), [[0, 3, 6], [3, 6, 9], [1, 4, 7],
                                    [4, 7, 10], [2, 5, 8], [5, 8, 11]],
                  window=3, variant="overlap")


def test_overlap_shift_requires_pose_existence():
    poses = _sparse_poses()
    del poses[4]
    got = PPU.view_selection(poses, window=3, variant="overlap")
    assert got == PU.view_selection(poses, window=3, variant="overlap")
    assert [1, 4, 7] not in got
    assert [0, 3, 6] in got and [2, 5, 8] in got


def test_w1_and_allframes():
    poses = _sparse_poses()
    _same_windows(poses, [[0], [3], [6], [9]], variant="w1")
    _same_windows(poses, [[0, 3, 6, 9]], variant="allframes")
    _same_windows(poses, [[0], [3], [6], [9]], window=1,
                  variant="nonoverlap")


def test_tqs_folds_scale_into_rotation():
    q = [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)]
    T = PPU.tqs_to_matrix([1, 2, 3], q, [2, 3, 4])
    assert np.array_equal(T, PU.tqs_to_matrix([1, 2, 3], q, [2, 3, 4]))
    R90 = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], float)
    np.testing.assert_allclose(T[:3, :3], R90 @ np.diag([2, 3, 4]),
                               atol=1e-12)
    np.testing.assert_allclose(T[:3, 3], [1, 2, 3])


def test_make_corners_ordering():
    bbox = np.array([-1, 1, -2, 2, -3, 3], float)
    ref = np.array([[-1, -2, -3], [1, -2, -3], [1, 2, -3], [-1, 2, -3],
                    [-1, -2, 3], [1, -2, 3], [1, 2, 3], [-1, 2, 3]], float)
    np.testing.assert_array_equal(PPU.make_corners(bbox), ref)
    np.testing.assert_array_equal(PU.make_corners(bbox), ref)


def test_get_level_thresholds():
    cases = [((1001, 0.86), 0), ((1000, 0.9), 1), ((501, 0.71), 1),
             ((101, 0.51), 2), ((100, 0.9), 3), ((5000, 0.5), 3)]
    for args, want in cases:
        assert PPU.get_level(*args) == PU.get_level(*args) == want


def test_points_inside_corners_strict():
    corners = PU.make_corners(np.array([-1, 1, -1, 1, -1, 1], float))[None]
    pts = np.array([[0, 0, 0], [0.99, 0.99, 0.99], [1.0, 0, 0],
                    [1.5, 0, 0]], float)
    want = PU.points_inside_corners(corners, pts)
    assert want[0] == 2
    assert np.array_equal(PPU.points_inside_corners_plain(corners, pts), want)
    got = PPU.points_inside_corners(
        torch.from_numpy(corners)[None], torch.from_numpy(pts)[None],
        torch.ones(1, 4, dtype=torch.bool))
    assert got.dtype == torch.int64 and np.array_equal(got[0].numpy(), want)


def _fov_intrinsic():
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 100.0
    K[0, 2], K[1, 2] = 32.0, 24.0
    return K


def test_fov_truncation_ratio_full_and_clipped():
    K = _fov_intrinsic()
    visible = PU.make_corners(
        np.array([-0.5, 0.5, -0.4, 0.4, 1.75, 2.25]))[None]
    behind = visible - np.array([0, 0, 5.0])
    corners = np.stack([visible, behind])              # (F=2, K=1, 8, 3)
    got = PPU.fov_truncation_ratio(torch.from_numpy(corners), (48, 64),
                                   K).numpy()
    for f, c in enumerate(corners):
        want = PU.fov_truncation_ratio(c, (48, 64), K)
        np.testing.assert_allclose(got[f], want, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(
            PPU.fov_truncation_ratio_plain(c, (48, 64), K), want)
    np.testing.assert_allclose(got[0], [1.0])
    assert got[1, 0] < 0.5


def test_depth_to_point_cloud_homogeneous():
    K = _fov_intrinsic()
    depth = np.zeros((2, 2), np.float32)
    depth[0, 1] = 2.0
    depth[1, 1] = 1.0
    want = PU.depth_to_point_cloud(depth, K)
    assert want.shape == (2, 3)
    np.testing.assert_array_equal(PPU.depth_to_point_cloud(depth, K), want)
    points, valid = PPU.depth_to_points(torch.from_numpy(depth)[None], K)
    assert points.shape == (1, 4, 3) and points.dtype == torch.float64
    np.testing.assert_array_equal(points[0][valid[0]].numpy(), want)


def test_catid_mapping():
    catids = ["03001627", "04379243", "99999999"]
    assert PPU.catids_to_labels(catids) == PU.catids_to_labels(catids) == \
        [0, 1, 8]


@pytest.fixture(scope="module")
def fake_raw(tmp_path_factory):
    """The JAX test's 2-scene layout, parsed by both toolchains."""
    root = tmp_path_factory.mktemp("scannet_raw")
    scans = os.path.join(root, "scans")
    _make_scene(scans, SCENES[0], _dense_poses(10))
    _make_scene(scans, SCENES[1], _sparse_poses())
    jpath = os.path.join(root, "full_annotations.json")
    with open(jpath, "w") as f:
        json.dump(_scan2cad_json(list(SCENES)), f)
    anno, panno = os.path.join(root, "anno"), os.path.join(root, "panno")
    with contextlib.redirect_stdout(io.StringIO()):
        parse_scan2cad.generate_anno(jpath, anno)
        PPARSE.generate_anno(jpath, panno)
    return {"root": str(root), "scans": scans, "anno": anno, "panno": panno}


def test_parse_scan2cad_output(fake_raw):
    names = sorted(os.listdir(fake_raw["anno"]))
    assert names == sorted(os.listdir(fake_raw["panno"])) and len(names) == 3
    for name in names:
        with open(os.path.join(fake_raw["anno"], name), "rb") as f, \
                open(os.path.join(fake_raw["panno"], name), "rb") as g:
            assert f.read() == g.read(), name
    d = _load(os.path.join(fake_raw["panno"], "scene0000_00.pkl"))
    models = d["aligned_models"]
    assert d["id_scan"] == "scene0000_00" and len(models) == 2
    np.testing.assert_allclose(
        models[0]["bboxes"], [-0.45, 0.45, -0.25, 0.25, -0.55, 0.55],
        atol=1e-12)
    np.testing.assert_allclose(models[0]["bbox_corners"].mean(0),
                               [0.55, 4.0, 0.0], atol=1e-12)


def _run_both(scans, anno, out, scenes, variant, split, window=3):
    """Stage 1 and 2 of each toolchain into out/jax and out/port; their
    stdout lines (the output directory replaced by OUT)."""
    lines = {}
    for name, mod, kw in (("jax", GEN, {}), ("port", PGEN,
                                            {"device": "cpu"})):
        d = os.path.join(out, name)
        os.makedirs(d)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            for s in scenes:
                assert mod.process_scene(scans, anno, d, s, variant, window,
                                         **kw) == s
            mod.get_roidb(d, split)
        lines[name] = text.getvalue().replace(d, "OUT").splitlines()
    return lines


def _assert_outputs_equal(out, scenes, split):
    jax_dir, port_dir = os.path.join(out, "jax"), os.path.join(out, "port")
    for s in scenes:
        want = _load(os.path.join(jax_dir, f"image_anno_{s}.pkl"))
        got = _load(os.path.join(port_dir, f"image_anno_{s}.pkl"))
        for a, b in zip(want["snippets"], got["snippets"]):
            assert a["image_ids"] == b["image_ids"]
            assert b["point_cloud_num_list"].dtype == np.int64
            np.testing.assert_array_equal(b["point_cloud_num_list"],
                                          a["point_cloud_num_list"])
        assert _same_tree(got, want), s
        assert _same_tree(_load(os.path.join(port_dir, "scene_anno",
                                             f"{s}.pkl")),
                          _load(os.path.join(jax_dir, "scene_anno",
                                             f"{s}.pkl"))), s
    roidb = f"scannet_{split}_gt_roidb.pkl"
    want = _load(os.path.join(jax_dir, roidb))
    assert _same_tree(_load(os.path.join(port_dir, roidb)), want)
    return want


def test_end_to_end_val(fake_raw, tmp_path):
    lines = _run_both(fake_raw["scans"], fake_raw["anno"], str(tmp_path),
                      SCENES, "nonoverlap", "val")
    assert lines["port"] == lines["jax"]
    items = _assert_outputs_equal(str(tmp_path), SCENES, "val")
    assert len(items) == 4
    s0 = _load(os.path.join(tmp_path, "port", "image_anno_scene0000_00.pkl"))
    assert [s["image_ids"] for s in s0["snippets"]] == \
        [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    snip = s0["snippets"][0]
    assert snip["point_cloud_num_list"][0] > 1000
    assert snip["point_cloud_num_list"][1] == 0
    assert snip["truncation_ratio_list"][0] > 0.85


def test_end_to_end_train_overlap(fake_raw, tmp_path):
    lines = _run_both(fake_raw["scans"], fake_raw["anno"], str(tmp_path),
                      SCENES, "overlap", "train")
    assert lines["port"] == lines["jax"]
    items = _assert_outputs_equal(str(tmp_path), SCENES, "train")
    assert len(items) == 8 + 6
    s1 = _load(os.path.join(tmp_path, "port", "image_anno_scene0001_00.pkl"))
    assert [s["image_ids"] for s in s1["snippets"]] == \
        [[0, 3, 6], [3, 6, 9], [1, 4, 7], [4, 7, 10], [2, 5, 8], [5, 8, 11]]


def test_generated_pickles_feed_dataloader(fake_raw, tmp_path):
    """(e) The port's pickles → parq_torch's ScanNetDataset → collate, as
    the JAX test feeds the JAX loader."""
    out = str(tmp_path / "dl")
    os.makedirs(out)
    with contextlib.redirect_stdout(io.StringIO()):
        for s in SCENES:
            PGEN.process_scene(fake_raw["scans"], fake_raw["anno"], out, s,
                               "nonoverlap", 3, device="cpu")
        PGEN.get_roidb(out, "val")
    from parq_torch.data.scannet import ScanNetDataset, collate
    ds = ScanNetDataset(fake_raw["scans"],
                        os.path.join(out, "scannet_val_gt_roidb.pkl"),
                        num_frames_per_snippet=3, image_size=(64, 48))
    assert len(ds) == 4
    batch = collate([ds[0], ds[1]])
    assert batch["rgb_img"].shape == (2, 3, 48, 64, 3)
    assert batch["camera"].shape == (2, 3, 6)
    for k in ("rgb_img", "T_world_pseudoCam", "T_world_local",
              "obbs_padded"):
        assert np.all(np.isfinite(batch[k])), k
    obbs = batch["obbs_padded"]
    real = obbs[0][obbs[0][:, -1] >= 0]
    assert real.shape[0] == 1 and real[0, -1] == 0


def test_port_pickles_feed_the_jax_loader(fake_raw, tmp_path):
    """(e) The JAX package's loader reads the port's pickles and builds the
    items it builds from its own toolchain's."""
    from parq_tpu.data.scannet import ScanNetDataset as JScanNetDataset
    _run_both(fake_raw["scans"], fake_raw["anno"], str(tmp_path), SCENES,
              "nonoverlap", "val")
    kw = dict(num_frames_per_snippet=3, image_size=(64, 48))
    want, got = (JScanNetDataset(fake_raw["scans"], os.path.join(
        tmp_path, name, "scannet_val_gt_roidb.pkl"), **kw)
        for name in ("jax", "port"))
    assert len(got) == len(want) == 4
    for i in range(4):
        a, b = want[i], got[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-12,
                                           atol=1e-12, err_msg=k)
            else:
                assert b[k] == a[k], k


# ---------------------------------------------------------------------------
# (b) the readers against PIL
# ---------------------------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_bytes(img, kinds, idat_parts=3):
    """A grayscale PNG of img (uint8 or uint16) with row r filtered by
    kinds[r % len(kinds)], its zlib stream split over several IDATs."""
    H, W = img.shape
    bpp = img.dtype.itemsize
    raw = img.astype(">u2" if bpp == 2 else np.uint8).tobytes()
    stride, out, prev = W * bpp, bytearray(), bytes(W * bpp)
    for r in range(H):
        row, kind = raw[r * stride:(r + 1) * stride], kinds[r % len(kinds)]
        filt = bytearray(stride)
        for i in range(stride):
            a = row[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) // 2,
                    _paeth(a, prev[i], c))[kind]
            filt[i] = (row[i] - pred) & 0xFF
        out += bytes([kind]) + filt
        prev = row
    z = zlib.compress(bytes(out))
    step = -(-len(z) // idat_parts)
    return (image_io.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8 * bpp, 0, 0,
                                          0, 0))
            + _chunk(b"tEXt", b"Comment\x00filtered by hand")
            + b"".join(_chunk(b"IDAT", z[i:i + step])
                       for i in range(0, len(z), step))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_read_png_gray_every_filter(tmp_path, bits, kinds):
    dtype = np.uint8 if bits == 8 else np.uint16
    img = np.random.RandomState(bits).randint(
        0, np.iinfo(dtype).max + 1, (13, 17)).astype(dtype)
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(img, kinds))
    got = image_io.read_png_gray(str(path))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("bits", [8, 16])
def test_read_png_gray_as_pil_writes_it(tmp_path, bits):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 2 ** bits, (48, 64)).astype(
        np.uint8 if bits == 8 else np.uint16)
    img[10:30] = img[10:30].cumsum(1) // 8        # smooth rows: PIL filters
    path = str(tmp_path / "p.png")
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(image_io.read_png_gray(path),
                                  np.asarray(Image.open(path)))


def test_read_png_gray_bad_crc_raises(tmp_path):
    data = bytearray(_png_bytes(np.arange(12, dtype=np.uint8).reshape(3, 4),
                                [0]))
    data[-20] ^= 0xFF                  # a byte of the last IDAT's body
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png_gray(str(path))


@pytest.mark.parametrize("maxval", [255, 65535, 100, 4095])
def test_read_pgm_matches_pil(tmp_path, maxval):
    rng = np.random.RandomState(maxval)
    img = rng.randint(0, maxval + 1, (9, 11))
    path = tmp_path / "d.pgm"
    if maxval in (255, 65535):              # as PIL writes them
        Image.fromarray(img.astype(np.uint8 if maxval == 255
                                   else np.uint16)).save(path)
    else:                                   # other maxvals, with a comment
        path.write_bytes(b"P5\n# made by hand\n11 9\n%d\n" % maxval
                         + img.astype(np.uint8 if maxval < 256
                                      else ">u2").tobytes())
    got = image_io.read_pgm(str(path))
    assert got.dtype == (np.uint8 if maxval < 256 else np.uint16)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    if maxval in (255, 65535):
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_jpeg_size(tmp_path, progressive):
    path = str(tmp_path / "c.jpg")
    Image.fromarray(np.zeros((97, 131, 3), np.uint8)).save(
        path, progressive=progressive, exif=b"Exif\x00\x00" + bytes(40))
    assert image_io.jpeg_size(path) == (97, 131) == \
        np.asarray(Image.open(path)).shape[:2]


@pytest.mark.parametrize("fmt", ["pgm", "png"])
def test_read_depth_equals_the_jax_side(tmp_path, fmt):
    depth = np.random.RandomState(3).randint(0, 9000, (20, 30)).astype(
        np.uint16)
    path = str(tmp_path / f"d.{fmt}")
    Image.fromarray(depth).save(path)
    got = image_io.read_depth(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, GEN.read_depth(path))


# ---------------------------------------------------------------------------
# (c) a seeded random layout, every view-selection variant
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def random_raw(tmp_path_factory):
    """Two scenes of chip_smoke's synthetic room at 128x96 depth, 24
    frames, 12 rotated boxes (one degenerate, three outside the room);
    scene 1 keeps some depth frames only as `{fid}.png` and one frame has
    none. The color frames are real JPEGs (the JAX side decodes one)."""
    root = str(tmp_path_factory.mktemp("random_raw"))
    scans, jpath = chip_smoke.write_synthetic_scannet(
        root, SCENES, seed=7, frames=24, depth_hw=(96, 128),
        color_hw=(48, 64), boxes=12)
    for s in SCENES:
        color = os.path.join(scans, s, "color")
        for name in os.listdir(color):
            Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(
                os.path.join(color, name), format="JPEG")
    depth = os.path.join(scans, SCENES[1], "depth")
    for fid in (2, 5, 11):
        pgm = os.path.join(depth, f"frame-{fid:06d}.depth.pgm")
        Image.fromarray(image_io.read_pgm(pgm)).save(
            os.path.join(depth, f"{fid}.png"))
        os.remove(pgm)
    os.remove(os.path.join(depth, "frame-000001.depth.pgm"))
    anno, panno = os.path.join(root, "anno"), os.path.join(root, "panno")
    with contextlib.redirect_stdout(io.StringIO()):
        parse_scan2cad.generate_anno(jpath, anno)
        PPARSE.main(["--scan2cad", jpath, "--out", panno])
    return {"root": root, "scans": scans, "anno": anno, "panno": panno,
            "json": jpath}


def test_random_layout_scan2cad_pickles_byte_equal(random_raw):
    names = sorted(os.listdir(random_raw["anno"]))
    assert names == sorted(os.listdir(random_raw["panno"]))
    for name in names:
        with open(os.path.join(random_raw["anno"], name), "rb") as f, \
                open(os.path.join(random_raw["panno"], name), "rb") as g:
            assert f.read() == g.read(), name
    d = _load(os.path.join(random_raw["panno"], f"{SCENES[0]}.pkl"))
    assert len(d["aligned_models"]) == 11        # the degenerate one skipped


@pytest.mark.parametrize("variant,split", [
    ("overlap", "train"), ("nonoverlap", "val"), ("w1", "val"),
    ("allframes", "train")])
def test_random_layout_equals_jax(random_raw, tmp_path, variant, split):
    lines = _run_both(random_raw["scans"], random_raw["anno"], str(tmp_path),
                      SCENES, variant, split)
    assert lines["port"] == lines["jax"]
    poses = GEN.read_scene_poses(os.path.join(random_raw["scans"], SCENES[1]))
    uses_frame_1 = any(1 in s for s in PU.view_selection(poses, 3, variant))
    assert (f"WARNING {SCENES[1]}: no depth for frame 1; assuming objects "
            "visible" in lines["port"]) == uses_frame_1
    _assert_outputs_equal(str(tmp_path), SCENES, split)
    counts = np.concatenate([
        s["point_cloud_num_list"] for scene in SCENES for s in _load(
            os.path.join(tmp_path, "port", f"image_anno_{scene}.pkl"))
        ["snippets"]])
    assert (counts == 0).any() and ((counts > 0) & (counts < 10 ** 6)).any()


# ---------------------------------------------------------------------------
# (d) each frame once: the per-snippet recomputation's numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_frame_dedup_equals_per_snippet(random_raw, chunk, monkeypatch):
    ctx = PGEN.load_scene(random_raw["scans"], random_raw["anno"], SCENES[1],
                          "overlap", 3)
    monkeypatch.setattr(PGEN, "CHUNK_FRAMES", chunk)
    snippets = ctx["snippets"][:12]          # overlapping: frames shared
    assert len({f for s in snippets for f in s}) < 3 * len(snippets)
    with contextlib.redirect_stdout(io.StringIO()):
        once = PGEN.snippet_records(ctx, snippets, device="cpu")
    for rec, frames in zip(once, snippets):
        counts, ratios = [], []
        for fid in frames:                      # the JAX side's loop, plain
            T_camera_scan = np.linalg.inv(ctx["poses"][fid])
            hom = np.concatenate([ctx["corners_scan"],
                                  np.ones((len(ctx["aligned"]), 8, 1))], -1)
            corners = (hom @ T_camera_scan.T)[..., :3]
            ratios.append(PPU.fov_truncation_ratio_plain(
                corners, ctx["image_shape"], ctx["intr_color"]))
            path = PGEN._depth_file(ctx["scene_dir"], fid)
            counts.append(np.full(len(ctx["aligned"]), 10 ** 6) if path is None
                          else PPU.points_inside_corners_plain(
                              corners, PPU.depth_to_point_cloud(
                                  image_io.read_depth(path),
                                  ctx["intr_depth"])))
        np.testing.assert_array_equal(rec["point_cloud_num_list"],
                                      np.max(np.stack(counts), 0))
        np.testing.assert_allclose(rec["truncation_ratio_list"],
                                   np.max(np.stack(ratios), 0), rtol=1e-12,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# (f) the device, the CLI and its process pool
# ---------------------------------------------------------------------------

def test_default_device_raises_without_gpu(fake_raw, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PGEN.process_scene(fake_raw["scans"], fake_raw["anno"], str(tmp_path),
                           SCENES[0], "nonoverlap", 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PGEN.main(["--scans", fake_raw["scans"], "--anno", fake_raw["anno"],
                   "--out", str(tmp_path / "cli")])
    assert not os.path.exists(tmp_path / "cli" / "scannet_train_gt_roidb.pkl")


def test_cli_cpu_pool_equals_one_process(random_raw, tmp_path):
    """`--device cpu --workers 2` (spawned processes over scenes) writes
    what one process writes, and the JAX CLI's stdout lines."""
    outs = {}
    for workers in (1, 2):
        out = str(tmp_path / f"w{workers}")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            PGEN.main(["--scans", random_raw["scans"], "--anno",
                       random_raw["anno"], "--out", out, "--split", "val",
                       "--workers", str(workers), "--device", "cpu"])
        assert text.getvalue().replace(out, "OUT").splitlines() == [
            "stage snippets: 2/2 scenes",
            "wrote %d snippets to OUT/scannet_val_gt_roidb.pkl"
            % len(_load(os.path.join(out, "scannet_val_gt_roidb.pkl")))]
        outs[workers] = out
    for name in [f"image_anno_{s}.pkl" for s in SCENES] + [
            "scannet_val_gt_roidb.pkl"]:
        assert _same_tree(_load(os.path.join(outs[2], name)),
                          _load(os.path.join(outs[1], name))), name


# ---------------------------------------------------------------------------
# (g) no PIL, cv2, imageio, JAX or scripts/ in the package
# ---------------------------------------------------------------------------

def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield from (a.name for a in node.names if node.module is None)


@pytest.mark.parametrize("name", ["__init__", "image_io", "processing_utils",
                                  "parse_scan2cad",
                                  "generate_scannet_anno_snippet"])
def test_package_imports_no_pil_or_jax(name):
    roots = set(_imported_roots(PACKAGE / f"{name}.py"))
    bad = roots & {"PIL", "cv2", "imageio", "jax", "jaxlib", "parq_tpu",
                   "scripts", "processing_utils", "parse_scan2cad",
                   "generate_scannet_anno_snippet"}
    assert not bad, f"{name}.py imports {sorted(bad)}"

"""The port's datasets and loader against the JAX package's (parq_tpu/data),
on fixture trees written with PIL in the reference's layouts (as
tests/test_data.py and tests/test_arkitscenes.py write them):

- ScanNet (with and without frame subsampling, over epochs), demo and
  ARKitScenes: every field of every item equals the JAX loader's exactly;
- SnippetLoader: order and contents over two shuffled epochs, synchronous,
  with the prefetch thread and with 2 worker processes; state_dict and a
  mid-epoch resume;
- host_shard_indices equals JAX's.
"""
import json
import pickle

import numpy as np
import pytest
from PIL import Image

from parq_tpu.data import DemoDataset as JDemoDataset
from parq_tpu.data import ScanNetDataset as JScanNetDataset
from parq_tpu.data import SnippetLoader as JSnippetLoader
from parq_tpu.data.arkitscenes import ARKitScenesDataset as JARKitDataset
from parq_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from parq_tpu.parallel.multihost import host_shard_indices as j_shard

from parq_torch.data import (DemoDataset, ScanNetDataset, SnippetLoader,
                             SyntheticDataset)
from parq_torch.data.arkitscenes import ARKitScenesDataset
from parq_torch.parallel import host_shard_indices


def rand_pose(rng):
    f = rng.randn(3) + np.array([1.0, 1.0, 0.2])
    f /= np.linalg.norm(f)
    x = np.cross([0.0, 0.0, 1.0], f)
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(f, x), f], axis=1)
    T[:3, 3] = rng.randn(3)
    return T


def save_jpg(rng, path, size=(64, 48)):
    Image.fromarray((rng.rand(size[1], size[0], 3) * 255)
                    .astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def fake_scannet(tmp_path_factory):
    """Three scenes x two snippets of 3 frames, boxes and symmetry tags."""
    rng = np.random.RandomState(0)
    tmp = tmp_path_factory.mktemp("scannet")
    root, anno = tmp / "scans", tmp / "anno"
    (anno / "scene_anno").mkdir(parents=True)
    roidb = []
    for s in range(3):
        scene = f"scene{s:04d}_00"
        (root / scene / "color").mkdir(parents=True)
        annos = {}
        for snip in range(2):
            ids = [snip * 3 + k for k in range(3)]
            for i in ids:
                save_jpg(rng, root / scene / "color"
                         / f"frame-{i:06d}.color.jpg")
            n_box = 2 + s
            poses = np.stack([rand_pose(rng) for _ in range(n_box)])
            annos[snip] = {
                "image_ids": ids,
                "T_scan_camera": [rand_pose(rng) for _ in ids],
                "intrinsic": [np.array([[50.0, 0, 32], [0, 50.0, 24],
                                        [0, 0, 1.0]])] * 3,
                "annotations": {
                    "bboxes": np.tile([[-.5, .5, -.4, .4, -.3, .3]],
                                      (n_box, 1)) * (1 + rng.rand(n_box, 1)),
                    "T_scan_object": poses,
                    "label": rng.randint(0, 9, n_box).astype(np.float64),
                    "sym": ["__SYM_NONE", "__SYM_ROTATE_UP_4", 2,
                            "__SYM_ROTATE_UP_INF"][:n_box],
                },
            }
            roidb.append({"scene_name": scene, "snippet_id": snip})
        with open(anno / "scene_anno" / f"{scene}.pkl", "wb") as f:
            pickle.dump(annos, f)
    gt = anno / "roidb.pkl"
    with open(gt, "wb") as f:
        pickle.dump(roidb, f)
    return str(root), str(gt)


def assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("frames", [3, 2])
def test_scannet_items_equal_jax(fake_scannet, frames):
    root, gt = fake_scannet
    kw = dict(num_frames_per_snippet=frames, image_size=(32, 24), seed=7)
    want, got = JScanNetDataset(root, gt, **kw), ScanNetDataset(root, gt, **kw)
    assert len(got) == len(want) == 6
    for epoch in range(2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        for i in range(len(want)):
            assert_items_equal(got[i], want[i])


def test_demo_items_equal_jax(tmp_path):
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
    want = JDemoDataset(str(tmp_path), str(gt), image_size=(32, 24))
    got = DemoDataset(str(tmp_path), str(gt), image_size=(32, 24))
    for i in range(2):
        assert_items_equal(got[i], want[i])


def test_arkitscenes_items_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    vid = "41069021"
    fd = tmp_path / vid / f"{vid}_frames"
    (fd / "lowres_wide").mkdir(parents=True)
    (fd / "lowres_wide_intrinsics").mkdir()
    lines = []
    for i in range(9):
        ts = 1000.0 + i * 0.5
        lines.append(" ".join(map(str, [ts, 0.1 * rng.randn(), 0.35 * i,
                                        0.05 * rng.randn(), *rng.randn(3)])))
        Image.fromarray((rng.rand(48, 64, 3) * 255).astype(np.uint8)).save(
            fd / "lowres_wide" / f"{vid}_{ts:.3f}.png")
        np.savetxt(fd / "lowres_wide_intrinsics" / f"{vid}_{ts:.3f}.pincam",
                   np.array([[64, 48, 50.0, 52.0, 32.0, 24.0]]))
    (fd / "lowres_wide.traj").write_text("\n".join(lines))
    data = [{"label": label, "segments": {"obbAligned": {
        "centroid": list(rng.randn(3)),
        "axesLengths": list(rng.rand(3) + 0.2),
        "normalizedAxes": list(np.eye(3).reshape(-1))}}}
        for label in ("chair", "table", "not-a-class")]
    with open(tmp_path / vid / f"{vid}_3dod_annotation.json", "w") as f:
        json.dump({"data": data}, f)
    want = JARKitDataset(str(tmp_path), image_size=(32, 24))
    got = ARKitScenesDataset(str(tmp_path), image_size=(32, 24))
    assert len(got) == len(want) > 1
    for i in range(len(want)):
        assert_items_equal(got[i], want[i])


def epochs(loader, n=2):
    return [b for _ in range(n) for b in loader]


@pytest.mark.parametrize("mode", [dict(prefetch=0), dict(prefetch=2),
                                  dict(num_workers=2, prefetch=1)],
                         ids=["sync", "thread", "workers"])
def test_loader_two_epochs_equal_jax(fake_scannet, mode):
    root, gt = fake_scannet
    kw = dict(num_frames_per_snippet=2, image_size=(32, 24), seed=3)
    want = epochs(JSnippetLoader(JScanNetDataset(root, gt, **kw), 2,
                                 shuffle=True, seed=5, prefetch=0))
    loader = SnippetLoader(ScanNetDataset(root, gt, **kw), 2, shuffle=True,
                           seed=5, **mode)
    got = epochs(loader)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert_items_equal(a, b)
    assert loader.state_dict() == {"epoch": 2, "position": 0, "seed": 5}


def test_loader_mid_epoch_resume_equals_jax():
    """Stop after one batch of the second epoch, resume from state_dict in a
    new loader (with its prefetch thread): the rest equals JAX's."""
    ds = SyntheticDataset(6, image_size=(32, 24), seed=0)
    want = epochs(JSnippetLoader(JSyntheticDataset(6, image_size=(32, 24),
                                                   seed=0), 2, seed=9,
                                 prefetch=0))
    loader = SnippetLoader(ds, 2, seed=9, prefetch=2)
    got = list(loader)
    it = iter(loader)
    got.append(next(it))
    state = loader.state_dict()
    assert state == {"epoch": 1, "position": 1, "seed": 9}
    resumed = SnippetLoader(SyntheticDataset(6, image_size=(32, 24), seed=0),
                            2, seed=0, prefetch=2)
    resumed.load_state_dict(state)
    got += list(resumed)
    assert resumed.state_dict() == {"epoch": 2, "position": 0, "seed": 9}
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert_items_equal(a, b)


@pytest.mark.parametrize("n, count", [(10, 1), (10, 3), (7, 4), (3, 5)])
def test_host_shard_indices_equal_jax(n, count):
    order = np.random.RandomState(n).permutation(n)
    for index in range(count):
        assert np.array_equal(host_shard_indices(order, index, count),
                              j_shard(order, index, count))

"""The port's host C++ library (`parq_torch.native`) against the JAX
package's (`parq_tpu.native`) and against the port's plain numpy versions,
on the same seeded inputs:

- `lap_solve` gives the JAX library's totals (and scipy's);
- `iou3d_matrix` agrees with the JAX library to 1e-9 on distinct boxes in
  general position, and with the port's `iou3d` to 1e-9 on 200 random
  rotated boxes, each box against itself included: there it gives 1 where
  the JAX library's strict clip gives NaN or a wrong value (the repair);
- `nms3d` gives the JAX library's keep mask and `greedy_nms`'s picks, and
  on tied scores takes boxes in index order, as `greedy_nms` and both
  packages' `nms_mask_device` do;
- F1 through the library equals F1 through the port's `iou3d` on a stream
  that shows one GT box in two snippets;
- the build: a failed compile raises with g++'s output, and processes that
  build at the same moment each load a whole library.
"""
import threading

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from parq_tpu import native as j_native

from parq_torch import native
from parq_torch.evals import F1Calculator, iou3d, to_odam
from parq_torch.evals.iou3d import ROTX90
from parq_torch.evals.nms import greedy_nms


def roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def box_corners(center, size, yaw):
    """(8, 3) reference-ordered world corners of a yaw-rotated box."""
    signs = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
    c = -np.asarray(size) / 2.0 + signs * np.asarray(size)
    return c @ (ROTX90 @ roty(yaw)).T + np.asarray(center)


def random_boxes(rng, n, spread=0.4):
    return np.stack([to_odam(box_corners(rng.randn(3) * spread,
                                         rng.rand(3) + 0.4,
                                         rng.uniform(-np.pi, np.pi)))
                     for _ in range(n)])


@pytest.mark.parametrize("shape,ties", [((5, 8), False), ((8, 8), False),
                                        ((6, 11), True)])
def test_lap_solve_totals_equal_jax(shape, ties):
    rng = np.random.RandomState(shape[0] + shape[1])
    cost = (rng.randint(0, 3, shape) if ties else rng.randn(*shape))
    cost = cost.astype(np.float64)
    got, want = native.lap_solve(cost), j_native.lap_solve(cost)
    rows = np.arange(shape[0])
    assert len(set(got.tolist())) == shape[0]
    r, c = linear_sum_assignment(cost)
    assert cost[rows, got].sum() == pytest.approx(cost[rows, want].sum(),
                                                  abs=1e-12)
    assert cost[rows, got].sum() == pytest.approx(cost[r, c].sum(),
                                                  abs=1e-12)
    if shape[0] < shape[1]:
        with pytest.raises(ValueError):
            native.lap_solve(cost.T)             # more rows than columns


def test_iou3d_matrix_equals_jax_library():
    rng = np.random.RandomState(2)
    a, b = random_boxes(rng, 30), random_boxes(rng, 20)
    got = native.iou3d_matrix(a, b)
    assert got.shape == (30, 20) and (got > 0).sum() > 20
    np.testing.assert_allclose(got, j_native.iou3d_matrix(a, b), rtol=0,
                               atol=1e-9)
    assert native.iou3d_pair(a[3], b[4]) == got[3, 4]
    assert native.iou3d_matrix(a[:0], b).shape == (0, 20)


def test_iou3d_matrix_equals_python_iou3d_with_self_iou_one():
    rng = np.random.RandomState(5)
    boxes = random_boxes(rng, 200)
    got = native.iou3d_matrix(boxes, boxes)
    want = np.array([[iou3d(a, b)[0] for b in boxes] for a in boxes])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.diag(got), 1.0, rtol=0, atol=1e-9)
    # the JAX library's strict clip: NaN or wrong on most of them
    with np.errstate(all="ignore"):
        jax_self = np.array([j_native.iou3d_pair(a, a) for a in boxes])
    assert (np.abs(jax_self - 1.0) < 1e-9).sum() < len(boxes) // 2


def _nms_rows(rng, n):
    lo = rng.uniform(-1.0, 1.0, (n, 3))
    rows = np.zeros((n, 8))
    rows[:, 0:3] = lo
    rows[:, 3:6] = lo + rng.uniform(0.2, 1.0, (n, 3))
    rows[:, 6] = rng.permutation(n) / n + 0.01
    rows[:, 7] = rng.randint(0, 4, n)
    return rows


@pytest.mark.parametrize("same_class,thresh", [(False, 0.1), (True, 0.2),
                                               (False, 0.5)])
def test_nms3d_equals_jax_and_greedy(same_class, thresh):
    rows = _nms_rows(np.random.RandomState(7), 60)
    keep = native.nms3d(rows, thresh, same_class)
    assert keep.any() and not keep.all()
    np.testing.assert_array_equal(keep,
                                  j_native.nms3d(rows, thresh, same_class))
    want = np.zeros(len(rows), bool)
    want[greedy_nms(rows, thresh, same_class)] = True
    np.testing.assert_array_equal(keep, want)
    assert native.nms3d(rows[:0], thresh, same_class).shape == (0,)


@pytest.mark.parametrize("same_class,thresh", [(False, 0.1), (True, 0.1)])
def test_nms3d_ties_go_in_index_order(same_class, thresh):
    """Scores on four levels (bf16 outputs tie often): nms3d, greedy_nms
    and the port's nms_mask_device all take tied boxes in index order, as
    the JAX package's nms_mask_device (a stable argsort) does. On these
    inputs the other order, or the JAX library's std::sort, keeps another
    set."""
    import jax.numpy as jnp
    import torch
    from parq_tpu.evals import nms_mask_device as j_nms_device
    from parq_torch.evals import nms_mask_device
    rng = np.random.RandomState(11)
    rows = _nms_rows(rng, 60)
    rows[:, :6] = np.round(rows[:, :6] * 32) / 32     # exact in f32
    rows[:, 6] = rng.randint(0, 4, 60) / 4.0
    keep = native.nms3d(rows, thresh, same_class)
    assert keep.any() and not keep.all()
    backwards = native.nms3d(rows[::-1].copy(), thresh, same_class)[::-1]
    assert (keep != backwards).any()
    want = np.zeros(len(rows), bool)
    want[greedy_nms(rows, thresh, same_class)] = True
    np.testing.assert_array_equal(keep, want)
    corners = np.stack([np.where(np.array([(i >> k) & 1 for k in range(3)]),
                                 rows[:, 3:6], rows[:, 0:3])
                        for i in range(8)], axis=1)
    labels = rows[:, 7].astype(np.int64)
    dev = nms_mask_device(torch.from_numpy(corners),
                          torch.from_numpy(rows[:, 6]),
                          torch.from_numpy(labels), 9, thresh, same_class)
    np.testing.assert_array_equal(keep, dev.numpy())
    jax_dev = j_nms_device(jnp.asarray(corners, jnp.float32),
                           jnp.asarray(rows[:, 6], jnp.float32),
                           jnp.asarray(labels), 9, thresh, same_class)
    np.testing.assert_array_equal(keep, np.asarray(jax_dev))


def _stream(rng):
    """Two scenes over three snippets; scene0's first GT box is seen, with
    the same corners, in every snippet (the clip's fault in the JAX
    library), the rest move by a little."""
    scenes = {f"scene{s}": [(rng.randn(3) * 1.5, rng.rand(3) + 0.5,
                             rng.uniform(-np.pi, np.pi), rng.randint(9))
                            for _ in range(4)] for s in range(2)}
    for _ in range(3):
        for scene, boxes in scenes.items():
            K = len(boxes) + 2
            corners = np.stack([box_corners(rng.randn(3) * 1.5,
                                            rng.rand(3) + 0.4,
                                            rng.uniform(-np.pi, np.pi))
                                for _ in range(K)])
            probs = rng.dirichlet(np.ones(10), K)
            for j, (c, size, yaw, cls) in enumerate(boxes):
                corners[j] = box_corners(c + rng.randn(3) * 0.05, size,
                                         yaw + 0.05 * rng.randn())
                probs[j] = 0.02 * rng.rand(10)
                probs[j, cls] = 1.0 - probs[j].sum() + probs[j, cls]
            gt = [box_corners(c if j == 0 and scene == "scene0"
                              else c + 1e-3 * rng.randn(3), size, yaw)
                  for j, (c, size, yaw, _) in enumerate(boxes)]
            yield ({"pred_corners_world": corners[None],
                    "sem_cls_prob": probs[None],
                    "pred_mask": np.ones((1, K), bool),
                    "scene_name": [scene]},
                   [{"labels": np.array([b[3] for b in boxes]),
                     "gt_corners_world": np.stack(gt)}])


def _python_iou3d_matrix(a, b):
    return np.array([[iou3d(x, y)[0] for y in b] for x in a]).reshape(
        len(a), len(b))


def _f1(stream):
    calc = F1Calculator(0.3)
    for outputs, gt in stream:
        calc.step(outputs, gt)
    return calc.compute_metrics(verbose=False), calc


def test_f1_through_library_equals_python_iou3d(monkeypatch):
    got, calc = _f1(_stream(np.random.RandomState(9)))
    monkeypatch.setattr(native, "iou3d_matrix", _python_iou3d_matrix)
    want, calc_py = _f1(_stream(np.random.RandomState(9)))
    assert got == want
    assert 0.0 < got["0.25_f1"] <= 1.0
    assert [len(t) for t in calc.gts.values()] == \
        [len(t) for t in calc_py.gts.values()] == [4, 4]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "native.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))


def test_concurrent_builds_each_load_a_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def one():
        try:
            paths.append(native.build())
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    import ctypes
    lib = ctypes.CDLL(str(paths[0]))
    assert lib.iou3d_pair is not None

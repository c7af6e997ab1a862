"""The port's eval stack against the JAX package's (parq_tpu/evals), and
the eval twin as a whole against the JAX eval path:

- iou3d on random rotated boxes to 1e-12; run_nms (class-agnostic and
  same-class) and nms_mask_device (K = 64, no score ties) give JAX's masks
  exactly;
- finish_parse_pred and targets_to_gt_list to 1e-6;
- F1Calculator fed one stream of predictions and GT over three scenes gives
  JAX's metrics dict exactly;
- `python -m parq_torch.cli.eval` on configs/smoke.yaml (8 synthetic
  snippets, weights of a JAX init) against `PARQModel.apply` + JAX's
  parse_pred_device / finish_parse_pred / F1Calculator on the same weights
  and snippets: per-snippet corners and scores to 2e-4, labels and
  pred_mask equal, the metrics equal. CONF_THRESH sits where no score lies
  within 1e-3 of it, and no predicted-vs-GT IoU lies within 1e-3 of an F1
  threshold; the test asserts both.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.config import get_cfg as j_get_cfg
from parq_tpu.config import update_config as j_update_config
from parq_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from parq_tpu.evals import F1Calculator as JF1Calculator
from parq_tpu.evals import finish_parse_pred as j_finish
from parq_tpu.evals import iou3d as j_iou3d
from parq_tpu.evals import nms_mask_device as j_nms_device
from parq_tpu.evals import parse_pred_device as j_parse_device
from parq_tpu.evals import run_nms as j_run_nms
from parq_tpu.evals import targets_to_gt_list as j_targets_to_gt
from parq_tpu.evals import to_odam
from parq_tpu.evals.f1 import _pairwise_iou
from parq_tpu.geometry import Obb3D as JObb3D
from parq_tpu.geometry import Pose as JPose
from parq_tpu.geometry import roty
from parq_tpu.losses import parse_targets as j_parse_targets
from parq_tpu.models import PARQModel as JPARQModel

import parq_torch.cli.eval as cli_eval
from parq_torch.evals import (F1Calculator, finish_parse_pred, iou3d,
                              nms_mask_device, parse_pred_device, run_nms,
                              targets_to_gt_list)
from parq_torch.geometry import Obb3D, Pose
from parq_torch.io.from_jax import state_dict_from_flax
from parq_torch.losses import parse_targets
from parq_torch.models import BATCH_KEYS
from parq_torch.train import loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROTX90 = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
TRACK_SCALE = (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0)


def box_corners(center, size, yaw):
    """(8, 3) reference-ordered world corners of a yaw-rotated box (the
    scan2cad convention of tests/test_evals.py)."""
    signs = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
    c = -np.asarray(size) / 2.0 + signs * np.asarray(size)
    return c @ (ROTX90 @ np.asarray(roty(yaw))).T + np.asarray(center)


def random_box(rng, spread=0.4):
    return box_corners(rng.randn(3) * spread, rng.rand(3) + 0.4,
                       rng.uniform(-np.pi, np.pi))


def test_iou3d_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(100):
        a, b = to_odam(random_box(rng)), to_odam(random_box(rng))
        np.testing.assert_allclose(iou3d(a, b), j_iou3d(a, b), atol=1e-12,
                                   rtol=0)


def test_iou3d_of_coincident_boxes_is_one():
    """A rotated box with itself (one GT box seen in two snippets): the
    port's IoU is 1; the JAX package's strict clip test gives NaN or a
    wrong value for more than half of 200 random rotated boxes (ROADMAP
    §C), so this is where the two packages differ."""
    rng = np.random.RandomState(5)
    boxes = [to_odam(random_box(rng)) for _ in range(200)]
    assert all(iou3d(a, a)[0] == pytest.approx(1.0, abs=1e-12) for a in boxes)
    with np.errstate(all="ignore"):
        jax_ok = sum(abs(j_iou3d(a, a)[0] - 1.0) < 1e-9 for a in boxes)
    assert jax_ok < len(boxes) // 2


def random_detections(rng, B, K, num_semcls=9):
    corners = np.stack([[random_box(rng, 1.0) for _ in range(K)]
                        for _ in range(B)])
    scores = rng.permutation(B * K).reshape(B, K) / (B * K) + 0.01
    labels = rng.randint(0, num_semcls + 1, (B, K))
    return corners, labels, scores


@pytest.mark.parametrize("nms_type, thresh", [
    ("nms_3d_faster", 0.1), ("nms_3d_faster_samecls", 0.2)])
def test_run_nms_equals_jax(nms_type, thresh):
    rng = np.random.RandomState(1)
    corners, labels, scores = random_detections(rng, 3, 40)
    got = run_nms(corners, labels, scores, 9, thresh, nms_type)
    want = j_run_nms(corners, labels, scores, 9, thresh, nms_type)
    assert got.any() and not got.all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("same_class", [False, True])
def test_nms_mask_device_equals_jax(same_class):
    rng = np.random.RandomState(2)
    corners, labels, scores = random_detections(rng, 1, 64)
    corners, labels = corners[0].astype(np.float32), labels[0]
    scores = scores[0].astype(np.float32)
    assert len(np.unique(scores)) == 64
    got = nms_mask_device(torch.from_numpy(corners), torch.from_numpy(scores),
                          torch.from_numpy(labels), 9, 0.1, same_class)
    want = j_nms_device(jnp.asarray(corners), jnp.asarray(scores),
                        jnp.asarray(labels), 9, 0.1, same_class)
    assert got.any() and not got.all()
    assert np.array_equal(got.numpy(), np.asarray(want))


def random_outputs(rng, B, K):
    logits = rng.randn(B, K, 10).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"size_unnormalized": rng.rand(B, K, 3).astype(np.float32) + 0.3,
            "center_unnormalized": (rng.randn(B, K, 3) * 0.8 + [0, 0, 1])
            .astype(np.float32),
            "sem_cls_prob": probs.astype(np.float32),
            "ortho6d": rng.randn(B, K, 6).astype(np.float32)}


@pytest.mark.parametrize("for_vis", [False, True])
def test_finish_parse_pred_equals_jax(for_vis):
    rng = np.random.RandomState(3)
    B, K = 2, 32
    out = random_outputs(rng, B, K)
    Twl = np.concatenate([np.eye(3).reshape(9), [0.3, -0.2, 0.1]])
    Twl = np.tile(Twl.astype(np.float32), (B, 1, 1))
    want = j_finish(j_parse_device({k: jnp.asarray(v) for k, v in out.items()},
                                   jnp.asarray(Twl), TRACK_SCALE, for_vis),
                    9, for_vis=for_vis)
    got = finish_parse_pred(
        parse_pred_device({k: torch.from_numpy(v) for k, v in out.items()},
                          torch.from_numpy(Twl), TRACK_SCALE, for_vis),
        9, for_vis=for_vis)
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k].dtype == bool or k == "labels":
            assert np.array_equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                       err_msg=k)


def test_targets_to_gt_list_equals_jax():
    from parq_torch.data.synthetic import make_batch
    batch = make_batch([0, 1, 2])
    want = j_targets_to_gt(j_parse_targets(
        JObb3D(jnp.asarray(batch["obbs_padded"])),
        JPose(jnp.asarray(batch["T_world_local"])),
        jnp.asarray(batch["sym"])))
    got = targets_to_gt_list(parse_targets(
        Obb3D(torch.from_numpy(batch["obbs_padded"])),
        Pose(torch.from_numpy(batch["T_world_local"])),
        torch.from_numpy(batch["sym"])))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["gt_corners_world"],
                                   w["gt_corners_world"], atol=1e-6, rtol=0)


def f1_stream(rng):
    """Snippets over three scenes: GT boxes seen again snippet after snippet,
    noisy predictions of them plus false positives, random scores."""
    scenes = {f"scene{s}": [(rng.randn(3) * 1.5, rng.rand(3) + 0.5,
                             rng.uniform(-np.pi, np.pi), rng.randint(9))
                            for _ in range(4 + s)] for s in range(3)}
    for snippet in range(4):
        for scene, boxes in scenes.items():
            seen = [b for b in boxes if rng.rand() < 0.7]
            K = len(seen) + 3
            corners = np.stack([random_box(rng, 1.5) for _ in range(K)])
            probs = rng.dirichlet(np.ones(10), K)
            for j, (c, size, yaw, cls) in enumerate(seen):
                corners[j] = box_corners(c + rng.randn(3) * 0.1,
                                         size * (1 + 0.1 * rng.randn(3)),
                                         yaw + 0.1 * rng.randn())
                probs[j] = 0.02 * rng.rand(10)
                probs[j, cls] = 1.0 - probs[j].sum() + probs[j, cls]
            outputs = {"pred_corners_world": corners[None],
                       "sem_cls_prob": probs[None],
                       "pred_mask": rng.rand(1, K) < 0.9,
                       "scene_name": [scene]}
            # GT moves by a little per snippet: a box seen twice with the
            # same corners meets the JAX clip's fault (ROADMAP §C)
            gt = [{"labels": np.array([b[3] for b in seen], np.int64),
                   "gt_corners_world": np.array(
                       [box_corners(b[0] + 1e-3 * rng.randn(3), *b[1:3])
                        for b in seen]).reshape(-1, 8, 3)}]
            yield outputs, gt


def test_f1_calculator_equals_jax():
    got, want = F1Calculator(0.3), JF1Calculator(0.3)
    for outputs, gt in f1_stream(np.random.RandomState(4)):
        got.step(outputs, gt)
        want.step(outputs, gt)
    m_got = got.compute_metrics(verbose=False)
    m_want = want.compute_metrics(verbose=False)
    assert m_got == m_want
    assert 0.0 < m_want["0.25_f1"] < 1.0
    assert sorted(got.preds) == sorted(want.preds) == ["scene0", "scene1",
                                                         "scene2"]


# ------------------------------------------------------- the slice: eval --
def smoke_jax_cfg():
    cfg = j_get_cfg()
    j_update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"), opts=None))
    return cfg


def jax_eval(jcfg, variables, dataset, batch_size, conf_thresh=None):
    """JAX's eval path: per-batch host outputs, and (with `conf_thresh`)
    the F1 calculator after the stream."""
    jmodel = JPARQModel.from_config(jcfg)
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True))
    dec = jcfg.MODEL.DECODER
    calc = JF1Calculator(conf_thresh or 0.5, num_semcls=dec.NUM_SEMCLS)
    hosts = []
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, start + batch_size)]
        batch = {k: jnp.asarray(np.stack([it[k] for it in items]))
                 for k in BATCH_KEYS + ("obbs_padded", "sym")}
        out = apply(variables, {k: batch[k] for k in BATCH_KEYS})
        dev = j_parse_device({k: v[-1] for k, v in out.items()},
                             batch["T_world_local"], tuple(dec.TRACK_SCALE))
        host = j_finish(dev, dec.NUM_SEMCLS,
                        enable_nms=bool(dec.ENABLE_NMS))
        host["scene_name"] = [it["scene_name"] for it in items]
        hosts.append(host)
        calc.step(host, j_targets_to_gt(j_parse_targets(
            JObb3D(batch["obbs_padded"]), JPose(batch["T_world_local"]),
            batch["sym"])))
    return hosts, calc


def threshold_in_gap(scores, lo=0.12, hi=0.5, margin=1e-3):
    """A confidence threshold in [lo, hi] at least `margin` from every
    score: the middle of the widest gap."""
    s = np.sort(np.concatenate([[lo], scores[(scores > lo) & (scores < hi)],
                                [hi]]))
    i = int(np.argmax(np.diff(s)))
    t = float((s[i] + s[i + 1]) / 2)
    assert np.abs(scores - t).min() > margin
    return t


def test_eval_cli_equals_jax_eval_path(tmp_path, monkeypatch):
    jcfg = smoke_jax_cfg()
    size = tuple(jcfg.TPU.IMAGE_SIZE)
    dataset = JSyntheticDataset(num_snippets=8, image_size=size, seed=1000)
    jmodel = JPARQModel.from_config(jcfg)
    example = {k: jnp.asarray(dataset[0][k])[None] for k in BATCH_KEYS}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3), example))
    rng = np.random.RandomState(4)
    variables["frozen"] = jax.tree_util.tree_map(
        lambda a: rng.rand(*a.shape).astype(np.float32) + 0.5,
        variables["frozen"])
    ckpt = str(tmp_path / "weights.pt")
    torch.save(state_dict_from_flax(variables), ckpt)
    B = int(jcfg.DATAMODULE.BATCH_SIZE)

    hosts, _ = jax_eval(jcfg, variables, dataset, B)
    kept = np.concatenate([h["scores"][h["pred_mask"]] for h in hosts])
    conf = threshold_in_gap(kept)
    hosts, calc = jax_eval(jcfg, variables, dataset, B, conf)
    want = calc.compute_metrics(verbose=False)
    for scene in calc.preds:
        iou = _pairwise_iou(calc.preds[scene], calc.gts.get(scene, []))
        for th in calc.f1_iou_thresh:
            assert not (np.abs(iou - th) < 1e-3).any(), (scene, th)

    seen = []                  # each batch's host outputs, as F1 reads them

    def spy(*a, **kw):
        seen.append(finish(*a, **kw))
        return seen[-1]

    finish = loop.finish_parse_pred
    monkeypatch.setattr(loop, "finish_parse_pred", spy)
    got = cli_eval.main([
        "--cfg", os.path.join(ROOT, "configs", "smoke.yaml"),
        "--CHECKPOINT_PATH", ckpt, "TPU.PLATFORM", "cpu",
        "DATAMODULE.DATA_PATH", "synthetic", "LOG_PATH", str(tmp_path),
        "MODEL.DECODER.CONF_THRESH", repr(conf)])
    assert len(seen) == len(hosts) == 8 // B
    for g, w in zip(seen, hosts):
        assert g["scene_name"] == w["scene_name"]
        for k in ("labels", "pred_mask", "valid"):
            assert np.array_equal(g[k], w[k]), k
        for k in ("pred_corners_world", "corners_local", "scores",
                  "sem_cls_prob"):
            np.testing.assert_allclose(g[k], w[k], atol=2e-4, rtol=0,
                                       err_msg=k)
    assert "mean_latency_s" in got and "total_loss" in got
    assert {k: v for k, v in got.items()
            if k not in ("mean_latency_s", "total_loss")} == want
    assert want["0.25_accuracy"] >= 0.0 and len(calc.preds) > 1

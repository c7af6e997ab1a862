"""parse_pred's NMS-and-pack kernel (parq_torch/kernels/nms.py), its CPU
side:

- the edge cases of `torch_common` that the card tests hold the kernel
  to are what they are named, in the host library's keep mask (`run_nms`,
  native.nms3d): IoU exactly at the threshold kept, one f32 ulp of a
  corner to either side, ties, all background, one box repeated, same
  class at 0.2;
- the pack that mirrors the kernel's column order, unpacked, is the CPU
  route's dict: the same keys, dtypes and values, with and without NMS,
  eval and vis;
- on the CPU parse_pred keeps the host route: no launch, no packed buffer,
  no copy counted; the packed route's host half takes the NMS settings
  the device half ran with.

The kernel itself is held against these on the card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from parq_torch import telemetry
from parq_torch.evals import finish_parse_pred, parse_pred, parse_pred_device
from parq_torch.evals.nms import run_nms
from parq_torch.evals.parse_pred import nms_settings
from parq_torch.kernels import nms as knms

import torch_common as tc

TRACK_SCALE = (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0)


def host_keep(corners, scores, labels, num_semcls, thresh, same):
    return run_nms(corners, labels, scores, num_semcls, thresh,
                   "nms_3d_faster_samecls" if same else "nms_3d_faster")


EDGE_KEEP = {"at": [1, 1], "above": [1, 0], "below": [1, 1],
             "ties": [1, 0, 0, 0, 1, 1, 0, 1], "background": [0] * 8,
             "same_box": [1] + [0] * 7, "same_class": [1, 1, 1, 0]}


@pytest.mark.parametrize("name", tc.NMS_EDGE_CASES)
def test_edge_cases_keep_what_they_are_named_for(name):
    want = host_keep(*tc.nms_edge_case(name))
    first = EDGE_KEEP[name]
    assert want[0, :len(first)].tolist() == [bool(k) for k in first]


def random_outputs(rng, B, K):
    logits = rng.randn(B, K, 10).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"size_unnormalized": rng.rand(B, K, 3).astype(np.float32) + 0.3,
            "center_unnormalized": (rng.randn(B, K, 3) * 0.8 + [0, 0, 1])
            .astype(np.float32),
            "sem_cls_prob": probs.astype(np.float32),
            "ortho6d": rng.randn(B, K, 6).astype(np.float32)}


def inputs(B=2, K=64, seed=3):
    """(last iteration's outputs, T_world_local) as CPU tensors."""
    rng = np.random.RandomState(seed)
    Twl = np.concatenate([np.eye(3).reshape(9), [0.3, -0.2, 0.1]])
    return ({k: torch.from_numpy(v) for k, v in
             random_outputs(rng, B, K).items()},
            torch.from_numpy(np.tile(Twl.astype(np.float32), (B, 1, 1))))


def device_half(**kw):
    return parse_pred_device(*inputs(), TRACK_SCALE, **kw)


def pack(dev, for_vis, enable_nms):
    """The plain pack of a device half's arrays, as the card's device half
    makes it."""
    return knms.nms_pack(dev["obb_data"], dev["corners_local"],
                         dev["corners_world"], dev["scores"],
                         dev["sem_cls_prob"], dev["labels"], dev["valid"],
                         tc.NMS_SEMCLS, *nms_settings(for_vis),
                         nms=enable_nms)


@pytest.mark.parametrize("for_vis", [False, True])
@pytest.mark.parametrize("enable_nms", [True, False])
def test_unpacked_pack_is_the_cpu_route(for_vis, enable_nms):
    dev = device_half(for_vis=for_vis, num_semcls=tc.NMS_SEMCLS,
                      enable_nms=enable_nms)
    want = finish_parse_pred(dev, tc.NMS_SEMCLS, enable_nms, for_vis)
    packed = pack(dev, for_vis, enable_nms)
    assert packed.shape == (2, 64, knms.FIXED_COLUMNS + 10)
    got = knms.unpack(packed.numpy())
    assert sorted(got) == sorted(set(want) - {"pred_corners_world"})
    for k, v in got.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        assert np.array_equal(v, want[k]), k
    assert want["pred_mask"].any()
    assert want["pred_mask"].all() == (for_vis and not enable_nms)


def test_cpu_route_takes_no_launch():
    telemetry.reset()
    before = knms.nms_pack.launches
    dev = device_half(num_semcls=tc.NMS_SEMCLS)
    assert "packed" not in dev and "nms" not in dev
    host = finish_parse_pred(dev, tc.NMS_SEMCLS)
    assert knms.nms_pack.launches == before
    counters = telemetry.snapshot()["counters"]
    assert "parse_pred.d2h_copies" not in counters
    assert counters["parse_pred.kept"] == int(host["pred_mask"].sum())
    again = parse_pred(*inputs(), TRACK_SCALE, tc.NMS_SEMCLS)
    assert knms.nms_pack.launches == before
    for k in host:
        assert np.array_equal(again[k], host[k]), k


def test_packed_host_half_is_one_copy_and_checks_the_settings():
    """A device half with a pack (made here by the plain version) takes
    the packed route: one copy counted, the NMS span around the unpacking,
    the counts with the device half's settings, and NMS settings given to
    the host half are not read: the pack holds the device half's."""
    dev = device_half(num_semcls=tc.NMS_SEMCLS)
    want = finish_parse_pred(dev, tc.NMS_SEMCLS)
    dev["packed"] = pack(dev, False, True)
    dev["nms"] = (tc.NMS_SEMCLS, True)
    telemetry.reset()
    got = finish_parse_pred(dev)
    snap = telemetry.snapshot()
    assert snap["counters"]["parse_pred.d2h_copies"] == 1
    assert snap["counters"]["parse_pred.nms_boxes"] == int(
        (want["labels"] != tc.NMS_SEMCLS).sum())
    assert snap["spans"]["parse_pred.nms"]["count"] == 1
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    for kw in ({"for_vis": True}, {"enable_nms": False},
               {"num_semcls": 3}):
        other = finish_parse_pred(dev, **kw)
        for k in want:
            assert np.array_equal(other[k], want[k]), (kw, k)
    with pytest.raises(ValueError, match="give num_semcls"):
        finish_parse_pred(device_half())

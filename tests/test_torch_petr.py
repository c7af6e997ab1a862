"""PETR in the port against the plain reference (`benchmark/reference/
petr.py`), on the CPU at a tiny size, on seeded random weights
(`benchmark/weights_petr.py`, whose DCN offsets move the sampling points
by a few pixels), and the PETR cell's loop and checks.

Tolerances, float32 against float32: the DCN columns 1e-5 (grid_sample's
normalised coordinates against the port's, a few ulps of the pixel
position); the whole forward's outputs 1e-5 relative (the port's 1x1
convs run as matrix products and its attention in SDPA, so sums reorder);
the decode exact in order, labels and kept flags (both rank the same f32
logits), 1e-6 in scores and 1e-5 relative in boxes (sigmoid, exp and
atan2 in another library).
"""
import copy
import importlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from benchmark import data_petr, program_petr
from benchmark.reference import petr as ref
from benchmark.reference.model import Precision
from benchmark.run import run_cell
from benchmark.weights_petr import make_weights
from benchmark.work import petr_flops
from parq_torch import telemetry
from parq_torch.config import ModelConfig, PETRConfig
from parq_torch.evals.petr_decode import petr_decode
from parq_torch.geometry import invert_4x4
from parq_torch.kernels import _build, launch_counts
from parq_torch.kernels.deform_conv import (deform_columns,
                                            deform_columns_plain,
                                            modulated_deform_conv)
from parq_torch.models import PARQModel, build_model, build_petr_model
from parq_torch.models.petr import PETRModel, sine_encoding_3d
from parq_torch.models.resnet_fpn import Bottleneck, ResNetBody
from parq_torch.ops import ModulatedDeformConv2d

import torch_common  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "eval-petr-r50dcn-b1"
TINY = dict(image_size=[128, 64], num_cams=2, embed_dims=32, num_heads=4,
            ffn_dim=64, num_layers=2, num_query=24, depth_num=8, max_num=20,
            compute_dtype="float32")


def tiny_cfg(**kw):
    cfg = json.loads((REPO / "benchmark" / "configs" / "petr-r50dcn-p4.json")
                     .read_text())
    cfg.update(TINY, **kw)
    return cfg


@pytest.fixture(scope="module")
def setup():
    """A tiny configuration, its weights, the port's model with them and
    two samples."""
    cfg = tiny_cfg()
    w = make_weights(cfg, 7, CPU)
    model = program_petr.build_model(cfg, w, CPU)
    pool = data_petr.make_pool(2, cfg, [5, 40], 7, CPU)
    return cfg, w, model, pool


def _dcn_case(N=2, C=16, H=6, W=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, C, H, W, generator=g)
    om = torch.randn(N, 27, H, W, generator=g) * 2.5
    om[:, 0:18:2, 0] -= 3.0          # first row: points off the top
    om[:, 0:18:2, -1] += 3.0         # last row: off the bottom
    om[:, 1:18:2, :, 0] -= 3.0       # first column: off the left
    om[:, 1:18:2, :, -1] += 3.0      # last column: off the right
    om[0, 0, 2, 2], om[0, 1, 2, 2] = -1e4, 1e4      # far off the map
    om[:, 18:] = om[:, 18:] * 0.4 + 0.7   # masks away from 0.5 and 1
    return x, om


def test_dcn_columns_match_the_reference_gather():
    x, om = _dcn_case()
    got = deform_columns_plain(x, om)                  # (N, H, W, 9, C)
    want = ref.dcn_columns(x, om)                      # (N, 9, C, H, W)
    torch.testing.assert_close(got, want.permute(0, 3, 4, 1, 2), rtol=0,
                               atol=1e-5)
    assert torch.equal(deform_columns(x, om), got)     # the CPU takes plain
    mask = torch.sigmoid(om[:, 18:])
    assert 0.2 < float(mask.mean()) < 0.8 and float(mask.max()) < 0.999
    # taps past every edge: a point far off samples exactly zero, and
    # points pushed off each edge still sample their in-map taps
    assert torch.count_nonzero(got[0, 2, 2, 0]) == 0
    assert torch.count_nonzero(got[:, 0]) > 0 and \
        torch.count_nonzero(got[:, :, -1]) > 0


def test_dcn_conv_matches_the_reference():
    x, om = _dcn_case(C=8)
    m = ModulatedDeformConv2d(8, 12)
    with torch.no_grad():
        m.conv_offset.weight.normal_(0, 0.5)
        m.conv_offset.bias.copy_(om.mean((0, 2, 3)))
    w = {"d.weight": m.weight.detach(),
         "d.conv_offset.weight": m.conv_offset.weight.detach(),
         "d.conv_offset.bias": m.conv_offset.bias.detach()}
    with torch.no_grad():
        got = m(x)
        want = ref.dcn(w, "d", x, Precision())
    assert got.shape == (2, 12, 6, 9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # mmcv's init: a zero offset conv makes the DCN a plain 3x3 conv at
    # half weight (sigmoid(0))
    plain = ModulatedDeformConv2d(8, 12)
    with torch.no_grad():
        torch.testing.assert_close(
            plain(x), 0.5 * torch.nn.functional.conv2d(x, plain.weight,
                                                       padding=1),
            rtol=1e-5, atol=1e-5)


def test_invert_4x4():
    m = torch.randn(3, 6, 4, 4, dtype=torch.float64) + 4 * torch.eye(4)
    torch.testing.assert_close(invert_4x4(m), torch.linalg.inv(m),
                               rtol=1e-9, atol=1e-12)


def _tilted_rig(n, cfg):
    """The benchmark's rig with the front camera pitched up by 60° about
    the lidar's y axis, so that much of its frustum leaves
    position_range's z span."""
    l2i = data_petr.rig(n, cfg["num_cams"], cfg["image_size"],
                        np.random.default_rng(1))
    c, s = np.cos(np.deg2rad(60)), np.sin(np.deg2rad(60))
    R = np.eye(4)
    R[0, 0], R[0, 2], R[2, 0], R[2, 2] = c, -s, s, c
    l2i[:, 0] = l2i[:, 0] @ R
    return torch.tensor(l2i, dtype=torch.float32)


def test_position_encoder_and_its_out_of_range_mask(setup):
    cfg, w, model, _ = setup
    head = model.pts_bbox_head
    l2i = _tilted_rig(2, cfg)
    W, H = cfg["image_size"]
    h, wd = H // cfg["stride"], W // cfg["stride"]
    pad = torch.zeros(2, cfg["num_cams"], h, wd, dtype=torch.bool)
    with torch.no_grad():
        pe, mask = head.position_embedding(l2i, pad)
        rpe, rmask = ref.position_embedding(w, cfg, l2i, Precision())
    torch.testing.assert_close(pe.permute(0, 1, 4, 2, 3), rpe, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(mask, rmask)
    assert mask.any() and not mask.all()


def test_sine_encoding_matches_the_reference():
    mask = torch.zeros(2, 3, 4, 5, dtype=torch.bool)
    mask[1, :, 3:] = True               # a padded band, as PETR pads
    mask[0, 2, :, 4] = True
    got = sine_encoding_3d(mask, 16)
    assert got.shape == (2, 3, 4, 5, 48)
    torch.testing.assert_close(got, ref.sine_encoding(mask, 16)
                               .permute(0, 1, 3, 4, 2), rtol=0, atol=1e-6)


def test_one_decoder_layer_matches_the_reference(setup):
    cfg, w, model, _ = setup
    g = torch.Generator().manual_seed(3)
    B, Q, N, D = 2, cfg["num_query"], 40, cfg["embed_dims"]
    tgt, qpos = torch.randn(B, Q, D, generator=g), \
        torch.randn(B, Q, D, generator=g)
    mem, kpos = torch.randn(B, N, D, generator=g), \
        torch.randn(B, N, D, generator=g)
    with torch.no_grad():
        got = model.pts_bbox_head.layers[1](tgt, qpos, mem + kpos, mem)
        want = ref.decoder_layer(w, cfg, 1, tgt, qpos, mem, kpos,
                                 Precision())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_forward_matches_the_reference(setup):
    cfg, w, model, pool = setup
    with torch.no_grad():
        got = model(pool)
        want = ref.forward(w, cfg, pool)
        ctrl = ref.forward(w, cfg, pool, Precision("fp8"))
    for k in ("all_cls_scores", "all_bbox_preds"):
        assert got[k].shape == (cfg["num_layers"], 2, cfg["num_query"], 10)
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert max(ref.output_gaps(got, want).values()) < 1e-5
    # the limit of the real cell lies between the sound and the control
    limit = json.loads((REPO / "benchmark" / "limits" / f"{CELL}.json")
                       .read_text())["output_gap"]
    assert max(ref.output_gaps(ctrl, want).values()) > limit
    # the centres lie in pc_range, inside post_center_range
    c = got["all_bbox_preds"][..., [0, 1, 4]]
    lo, hi = torch.tensor(cfg["pc_range"][:3]), \
        torch.tensor(cfg["pc_range"][3:])
    assert bool(((c >= lo) & (c <= hi)).all())


def _decode_both(cls, box, cfg):
    dets = petr_decode(cls, box, cfg["post_center_range"], cfg["max_num"])
    mine = ref.decode(cls.numpy(), box.numpy(), cfg["post_center_range"],
                      cfg["max_num"])
    return dets, mine


def test_the_decode_matches_the_reference(setup):
    cfg, _, model, pool = setup
    with torch.no_grad():
        out = model(pool)
    dets, mine = _decode_both(out["all_cls_scores"][-1],
                              out["all_bbox_preds"][-1], cfg)
    assert ref.decode_mismatch(dets, mine) == 0
    assert dets["boxes"].shape == (2, cfg["max_num"], 9)
    assert np.all(np.diff(dets["scores"], axis=1) <= 0)
    # out-of-range centres are dropped, and noticed
    box = out["all_bbox_preds"][-1].clone()
    box[0, :, 0] = 100.0
    dets, mine = _decode_both(out["all_cls_scores"][-1], box, cfg)
    assert not dets["keep"][0].any() and dets["keep"][1].all()
    assert ref.decode_mismatch(dets, mine) == 0
    mine["keep"][1, 0] = False
    assert ref.decode_mismatch(dets, mine) == 1


def test_the_top_k_breaks_ties_by_index():
    cfg = tiny_cfg(max_num=7)
    cls = torch.zeros(1, 4, 3)
    cls[0, 2, 1] = cls[0, 0, 2] = cls[0, 3, 0] = 2.0     # three tied best
    cls[0, 1, :] = -1.0
    box = torch.randn(1, 4, 10)
    dets, mine = _decode_both(cls, box, cfg)
    flat = [int(q) * 3 + int(l) for q, l in zip(dets["query"][0],
                                                 dets["labels"][0])]
    assert flat == [2, 7, 9, 0, 1, 6, 8]     # ties in index order
    assert ref.decode_mismatch(dets, mine) == 0


def test_backbone_styles_and_the_release_body():
    release = ResNetBody("resnet50")
    assert not any(isinstance(m, ModulatedDeformConv2d)
                   for m in release.modules())
    assert release.layer2[0].conv2.stride == (2, 2)
    assert release.layer2[0].conv1.stride == (1, 1)
    caffe = ResNetBody("resnet50", "caffe", (False, False, True, True))
    assert caffe.layer2[0].conv1.stride == (2, 2)
    assert caffe.layer2[0].conv2.stride == (1, 1)
    dcn = [n for n, m in caffe.named_modules()
           if isinstance(m, ModulatedDeformConv2d)]
    assert len(dcn) == 9 and all(n.startswith(("layer3", "layer4"))
                                 for n in dcn)
    assert {k for k in release.state_dict()} == \
        {k for k in caffe.state_dict() if "conv_offset" not in k}
    with pytest.raises(ValueError):
        Bottleneck(64, 64, stride=2, dcn=True)          # pytorch style
    with pytest.raises(ValueError):
        ResNetBody("resnet18", "caffe")


def test_the_state_dict_is_the_references_layout(setup):
    cfg, w, model, _ = setup
    assert set(model.state_dict()) == set(w)
    full = json.loads((REPO / "benchmark" / "configs" / "petr-r50dcn-p4.json")
                      .read_text())
    specs = {n: s for n, s, _ in ref.param_specs(full)}
    with torch.device("meta"):
        big = PETRModel(program_petr.petr_config(full))
    assert {k: tuple(v.shape) for k, v in big.state_dict().items()} == specs
    assert program_petr.petr_config(full) == PETRConfig(
        compute_dtype="bfloat16")          # the file is the published model


def test_the_entry_point_loads_a_state_dict_strictly(setup):
    cfg, w, model, _ = setup
    assert not model.training
    got = model.state_dict()
    assert all(torch.equal(got[k], v.to(got[k].dtype)) for k, v in w.items())
    seeded = build_petr_model(program_petr.petr_config(cfg), seed=3,
                              device="cpu")
    key = "pts_bbox_head.query_embedding.0.weight"
    assert not torch.equal(seeded.state_dict()[key], got[key])
    with pytest.raises(RuntimeError):
        build_petr_model(program_petr.petr_config(cfg), device="cpu",
                         state_dict={k: v for k, v in w.items()
                                     if "conv_offset" not in k})


def test_flops_count_the_ports_products(setup):
    cfg, _, model, pool = setup
    # the math backend, so that the counter sees attention's two products
    with torch.no_grad(), sdpa_kernel(SDPBackend.MATH), \
            FlopCounterMode(display=False) as fc:
        model({k: v[:1] for k, v in pool.items()})
    assert fc.get_total_flops() == petr_flops.sample_flops(cfg)
    full = json.loads((REPO / "benchmark" / "configs" / "petr-r50dcn-p4.json")
                      .read_text())
    assert petr_flops.sample_flops(full) / 2e9 == pytest.approx(448.69,
                                                                abs=0.01)
    assert petr_flops.forward_flops(full)["dcn"] / 2e9 == pytest.approx(
        89.69, abs=0.01)
    assert petr_flops.dcn_bytes(full, 1) == 654_964_992


@pytest.fixture
def rec():
    telemetry.reset()
    telemetry.enable(True)
    yield telemetry.RECORDER
    telemetry.enable(True)


def test_petr_records_its_init_and_decode(rec, setup):
    cfg, _, model, pool = setup
    build_petr_model(PETRConfig.tiny(), seed=1, device="cpu")
    with torch.no_grad():
        out = model(pool)
    for _ in range(3):
        telemetry.next_batch()
        dets = petr_decode(out["all_cls_scores"][-1],
                           out["all_bbox_preds"][-1],
                           cfg["post_center_range"], cfg["max_num"])
    snap = telemetry.snapshot()
    assert snap["spans"]["models.init"]["count"] == 1
    assert snap["spans"]["petr_decode.device"]["count"] == 3
    assert snap["spans"]["petr_decode.to_host"]["count"] == 3
    assert snap["counters"]["petr_decode.kept"] == 3 * int(
        dets["keep"].sum())
    assert "petr_decode.d2h_copies" not in snap["counters"]   # CPU
    assert "deform_conv" in launch_counts()


def test_building_parq_loads_no_deform_conv_library(monkeypatch):
    loaded = []
    monkeypatch.setattr(_build, "load", lambda name: loaded.append(name))
    model = build_model(ModelConfig.tiny(), seed=0, device="cpu")
    assert isinstance(model, PARQModel)
    assert not any(isinstance(m, ModulatedDeformConv2d)
                   for m in model.modules())
    assert "deform_conv" not in loaded and "deform_conv" not in _build._libs


# ---- the cell's loop and checks at a tiny size ---------------------------

def make_root(tmp: Path) -> Path:
    """`tmp` as a checkout with the benchmark and a tiny PETR cell beside
    the real ones (new files and entries only)."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs" / "tiny-petr.json").write_text(
        json.dumps(tiny_cfg()))
    bench["configs"].append({"name": "tiny-petr", "source": "test",
                             "file": "benchmark/configs/tiny-petr.json",
                             "reduced": [], "why": "CPU test"})
    tr = json.loads((REPO / "benchmark" / "traffic" / "eval-petr-b1.json")
                    .read_text())
    tr.update(pool_batches=2, trace_from=0.0, trace_batches=2,
              check_batches=2)
    (tmp / "benchmark" / "traffic" / "tiny-petr.json").write_text(
        json.dumps(tr))
    (tmp / "benchmark" / "limits" / "tiny-petr-eval.json").write_text(
        json.dumps({"output_gap": 1e-4, "decode_mismatch": 0}))
    bench["workloads"].append({"name": "tiny-petr-eval",
                               "config": "tiny-petr", "traffic": "tiny-petr",
                               "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-petr-eval")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def _run(root, trace=False, seed=2 ** 31 + 9):
    out, _ = run_cell(root, "tiny-petr-eval", seed, 0.5, trace, CPU, 0.0)
    return out


def test_the_cell_runs_correct_and_reads_its_metrics(tmp_path):
    root = make_root(tmp_path)
    out = _run(root)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"eval_frames_per_s", "setup_s"}
    assert out["checks"]["output_gap"]["value"] < 1e-5
    out = _run(root, trace=True)
    assert out["correct"]
    # no card: no marks, no kernels, no capture and no copy from a card, so
    # those metrics read nothing; the model's init and the trace's idle
    # share are read on any device
    assert not {"petr_fwd_mfu.replay", "dcn_roofline.petr",
                "post_fwd_ms.petr", "host_gap_ms.petr", "capture_s.petr",
                "d2h_copies.petr"} & set(out["metrics"])
    assert {"model_init_s.petr", "idle_share.petr"} <= set(out["metrics"])
    assert out["metrics"]["model_init_s.petr"]["value"] > 0


def test_a_stale_forward_fails_the_cell(tmp_path, monkeypatch):
    """Every call after the second hands back the second call's outputs
    (pool batch 1), as a replay whose new inputs never reach the graph
    would: the window's first batch is pool batch 0, so even a window of
    one batch checks a stale output."""
    graphs = importlib.import_module("parq_torch.graphs")
    real = graphs.Graphed.__call__
    calls = []

    def stale(self, *a, **kw):
        calls.append(copy.deepcopy(real(self, *a, **kw)))
        return calls[min(len(calls) - 1, 1)]
    monkeypatch.setattr(graphs.Graphed, "__call__", stale)
    out = _run(make_root(tmp_path))
    assert not out["correct"]
    assert out["checks"]["output_gap"]["value"] > 1e-3


def test_an_altered_decode_fails_the_cell(tmp_path, monkeypatch):
    pd = importlib.import_module("parq_torch.evals.petr_decode")
    real = pd.finish_petr_decode

    def altered(packed):
        host = real(packed)
        host["labels"][0, -1] = (host["labels"][0, -1] + 1) % 10
        return host
    monkeypatch.setattr(pd, "finish_petr_decode", altered)
    out = _run(make_root(tmp_path))
    assert not out["correct"]
    assert out["checks"]["decode_mismatch"]["value"] >= 1

"""BEVFormer in the port against the plain reference (`benchmark/reference/
bevformer.py`), on the CPU at a tiny size, on seeded random weights
(`benchmark/weights_bevformer.py`, whose deformable offsets move the
sampling points by a few cells and whose logits are far from uniform),
and the BEVFormer cell's loop and checks.

Tolerances, float32 against float32: the deformable attention 1e-5
(grid_sample's normalised coordinates against the port's, a few ulps of
the pixel position, and sums reordered); the projected anchors 1e-5
relative (the port's sums against a matmul); layers and the forward 1e-4
relative (sums reorder through the layers and the carried BEV); the
rotation exact (the same grid and nearest sampling); the decode exact in
order, labels and kept flags, 1e-6 in scores and 1e-5 relative in boxes
(`reference.petr.decode_mismatch`).
"""
import copy
import importlib
import json
import shutil
from pathlib import Path

import pytest
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from benchmark import data_bevformer, program_bevformer
from benchmark.reference import bevformer as ref
from benchmark.reference.model import Precision
from benchmark.run import run_cell
from benchmark.weights_bevformer import make_weights
from benchmark.work import bevformer_flops
from parq_torch import telemetry
from parq_torch.config import BEVFormerConfig, ModelConfig, PETRConfig
from parq_torch.evals.petr_decode import petr_decode
from parq_torch.kernels import _build, launch_counts
from parq_torch.kernels.ms_deform_attn import (ms_deform_attn,
                                               ms_deform_attn_plain)
from parq_torch.models import (BEVStream, PARQModel, PETRModel,
                               build_bevformer_model, build_model,
                               build_petr_model)
from parq_torch.models.bevformer import (can_bus_deltas, bev_shift,
                                         rotate_bev, rotation_grid)

import torch_common  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "eval-bevformer-base-b1"
TINY = dict(image_size=[128, 72], num_cams=2, embed_dims=32, num_heads=4,
            ffn_dim=64, bev_h=8, bev_w=8, encoder_layers=2,
            decoder_layers=2, num_query=24, max_num=20,
            rotate_center=[4.0, 4.0], compute_dtype="float32")


def tiny_cfg(**kw):
    cfg = json.loads((REPO / "benchmark" / "configs" / "bevformer-base.json")
                     .read_text())
    cfg.update(TINY, **kw)
    return cfg


@pytest.fixture(scope="module")
def setup():
    """A tiny configuration (three cameras, so that cells are seen by
    none, one and two of them), its weights, the port's model with them
    and a three-sample scene."""
    cfg = tiny_cfg(num_cams=3)
    w = make_weights(cfg, 7, CPU)
    model = program_bevformer.build_stream(cfg, w, CPU)[0]
    pool = data_bevformer.make_scene(3, cfg, [5, 40], 7, CPU)
    return cfg, w, model, pool


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def sample(pool, i):
    return {k: v[i:i + 1] for k, v in pool.items()}


# ---- multi-scale deformable attention -------------------------------------

def _msda_case(F_=3, G=1, A=2, P=4, Q=9, Hh=2, d=4, seed=0):
    """Levels of several sizes, reference points spread past every edge of
    [0, 1], offsets of a few cells, logits far from uniform."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(5, 7), (3, 4), (2, 2)]
    Nv = sum(h * w for h, w in shapes)
    value = torch.randn(1, F_, Nv, Hh, d, generator=g)
    refp = torch.rand(1, F_, Q, A, 2, generator=g) * 1.6 - 0.3
    refp[0, :, 0, 0] = torch.tensor([-0.2, 0.5])        # off the left
    refp[0, :, 1, 0] = torch.tensor([1.3, 0.5])         # off the right
    refp[0, :, 2, 0] = torch.tensor([0.5, -0.2])        # off the top
    refp[0, :, 3, 0] = torch.tensor([0.5, 1.3])         # off the bottom
    off = torch.randn(1, Q, Hh, G, len(shapes), P, 2, generator=g) * 2
    logits = torch.randn(1, Q, Hh, G, len(shapes) * P, generator=g) * 3
    return value, shapes, refp, off, logits


def _reference_frames(value, shapes, refp, off, logits):
    """Per frame, the reference's grid_sample form: (F, Q, H · d)."""
    _, F_, _, Hh, d = value.shape
    _, Q, _, G, L, P, _ = off.shape
    A = refp.shape[3]
    s = torch.tensor(shapes, dtype=torch.float32)
    norm = torch.stack([s[:, 1], s[:, 0]], -1)
    outs = []
    for f in range(F_):
        gi = f if G > 1 else 0
        a = logits[:, :, :, gi].softmax(-1).view(1, Q, Hh, L, P)
        o = (off[:, :, :, gi] / norm[None, None, None, :, None, :]).view(
            1, Q, Hh, L, P // A, A, 2)
        loc = refp[:, f][:, :, None, None, None] + o
        outs.append(ref.msda(value[:, f], shapes, loc.view(1, Q, Hh, L, P,
                                                           2), a)[0])
    return torch.stack(outs)


def test_msda_plain_takes_each_querys_cameras():
    """The spatial cross-attention's form: a camera with no hits, a query
    that no camera hits (0, as the published slots / max(count, 1)),
    points past every edge; each query's hit cameras summed over their
    count."""
    value, shapes, refp, off, logits = _msda_case()
    Q = off.shape[1]
    hit = torch.rand(1, 3, Q, generator=torch.Generator().manual_seed(1)) \
        > 0.4
    hit[0, 2] = False                     # a camera that sees nothing
    hit[0, :, 5] = False                  # a query no camera sees
    hit[0, 0, 0] = True
    got = ms_deform_attn(value, shapes, refp, off, logits, hit)
    frames = _reference_frames(value, shapes, refp, off, logits)
    want = torch.zeros_like(frames[0])
    for f in range(3):                    # the published slots, in order
        want[hit[0, f]] += frames[f][hit[0, f]]
    want = want / hit[0].sum(0).clamp(min=1)[:, None]
    torch.testing.assert_close(got[0], want, rtol=0, atol=1e-5)
    assert torch.count_nonzero(got[0, 5]) == 0


def test_msda_plain_means_the_temporal_pair():
    """The temporal self-attention's form: two frames, each with its own
    offsets and logits (G = 2), one reference point (A = 1), the mean."""
    value, shapes, refp, off, logits = _msda_case(F_=2, G=2, A=1)
    got = ms_deform_attn_plain(value, shapes, refp[:, :1], off, logits)
    frames = _reference_frames(value, shapes,
                               refp[:, :1].expand(-1, 2, -1, -1, -1), off,
                               logits)
    torch.testing.assert_close(got[0], frames.mean(0), rtol=0, atol=1e-5)


def test_msda_refuses_mismatched_shapes():
    value, shapes, refp, off, logits = _msda_case()
    with pytest.raises(ValueError):
        ms_deform_attn(value, shapes[:2], refp, off, logits)
    with pytest.raises(ValueError):
        ms_deform_attn(value, shapes, refp, off, logits,
                       torch.ones(1, 2, off.shape[1], dtype=torch.bool))


# ---- geometry, rebatch and the carry --------------------------------------

def test_point_sampling_and_its_mask(setup):
    cfg, _, model, pool = setup
    l2i = pool["lidar2img"][:1]
    got_ref, got_hit = model.pts_bbox_head.point_sampling(l2i)
    want_ref, want_mask = ref.point_sampling(cfg, l2i)
    want_ref = want_ref.permute(1, 0, 2, 3, 4)          # (B, N, Q, A, 2)
    want_mask = want_mask.permute(1, 0, 2, 3)
    fine = want_mask.all(-1)[..., None, None].expand_as(want_ref)
    torch.testing.assert_close(got_ref[fine], want_ref[fine], rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got_hit, want_mask.any(-1))
    n = got_hit[0].sum(0)
    assert (n == 0).any() and (n == 1).any() and (n >= 2).any()


def test_the_device_rebatch_is_the_published_one(setup):
    """The port's hit mask names exactly the published per-camera index
    lists, and its spatial cross-attention (no rebatch: the kernel walks
    each query's cameras) equals the reference's max_len rebatch."""
    cfg, w, model, pool = setup
    l2i = pool["lidar2img"][:1]
    ref_cam, hit = model.pts_bbox_head.point_sampling(l2i)
    rc, mask = ref.point_sampling(cfg, l2i)
    idx, max_len = ref.rebatch(mask)
    for c, ix in enumerate(idx):
        assert torch.equal(hit[0, c].nonzero().squeeze(-1), ix)
    assert max_len == int(hit[0].sum(-1).max())
    g = torch.Generator().manual_seed(3)
    Qb, D = cfg["bev_h"] * cfg["bev_w"], cfg["embed_dims"]
    query = torch.randn(1, Qb, D, generator=g)
    shapes = ref.level_shapes(cfg)
    Nv = sum(h * w for h, w in shapes)
    feats = torch.randn(cfg["num_cams"], Nv, 1, D, generator=g)
    layer = model.pts_bbox_head.transformer.encoder.layers[0]
    with torch.no_grad():
        got = layer.attentions[1](query, feats.permute(2, 0, 1, 3), shapes,
                                  ref_cam, hit)
        want = ref.sca(w, cfg, "pts_bbox_head.transformer.encoder.layers.0."
                       "attentions.1", query, feats, shapes, rc, mask,
                       Precision())
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("angle", [0.0, 90.0, -90.0, 180.0])
def test_rotation_by_quarter_turns(angle):
    """torchvision's rotate about the map's centre: 0 is the identity,
    ±90 degrees (counter-clockwise for positive) torch.rot90, 180 a
    double flip."""
    H = W = 6
    prev = torch.randn(1, H * W, 3, generator=torch.Generator()
                       .manual_seed(0))
    base = BEVFormerConfig.tiny(bev_h=H, bev_w=W)
    from parq_torch.models.bevformer import BEVFormerHead
    head = BEVFormerHead(base)
    grid = rotation_grid(head.rotation_base, torch.tensor(
        [angle], dtype=torch.float64), (W / 2, H / 2), (H, W))
    got = rotate_bev(prev, grid).view(H, W, 3)
    m = prev.view(H, W, 3)
    want = {0.0: m, 90.0: torch.rot90(m, 1, (0, 1)),
            -90.0: torch.rot90(m, -1, (0, 1)),
            180.0: m.flip(0).flip(1)}[angle]
    assert torch.equal(got, want)
    r = ref.rotate(m.permute(2, 0, 1), angle, (W / 2, H / 2))
    assert torch.equal(r.permute(1, 2, 0), want)


def test_rotation_matches_the_reference_and_fills_corners_with_zero():
    H, W = 8, 10
    g = torch.Generator().manual_seed(1)
    prev = torch.randn(2, H * W, 4, generator=g) + 5.0     # no zeros
    angles = torch.tensor([37.0, -121.5], dtype=torch.float64)
    from parq_torch.models.bevformer import BEVFormerHead
    head = BEVFormerHead(BEVFormerConfig.tiny(bev_h=H, bev_w=W))
    centre = (W / 2, H / 2)
    got = rotate_bev(prev, rotation_grid(head.rotation_base, angles, centre,
                                         (H, W)))
    want = ref.rotate_bev({"bev_h": H, "bev_w": W, "rotate_center": centre},
                          prev, angles.tolist())
    assert torch.equal(got, want)
    corners = got.view(2, H, W, 4)[:, [0, 0, -1, -1], [0, -1, 0, -1]]
    assert torch.count_nonzero(corners) == 0


def test_can_bus_deltas_and_the_shift(setup):
    cfg, _, _, pool = setup
    can = pool["can_bus"]
    for prev in (None, can[:1]):
        got = can_bus_deltas(can[1:2], prev)
        want = ref.can_bus_deltas(can[1:2], prev)
        assert torch.equal(got, want)
        c = BEVFormerConfig.tiny()
        torch.testing.assert_close(bev_shift(c, got), ref.shift_of(cfg, want),
                                   rtol=1e-6, atol=1e-7)
    assert torch.count_nonzero(ref.shift_of(cfg, can_bus_deltas(
        can[1:2], None))) == 0
    assert torch.count_nonzero(bev_shift(BEVFormerConfig.tiny(),
                                         can_bus_deltas(can[1:2],
                                                        can[:1]))) == 2


# ---- layers ----------------------------------------------------------------

def _bev_inputs(cfg, w, pool, i=0):
    """The encoder's inputs of sample i at the tiny size, from the
    reference: the queries, positions, features, anchors and mask."""
    x = sample(pool, i)
    feats = ref.image_features(w, cfg, x["img"], Precision())
    shapes = [tuple(f.shape[-2:]) for f in feats]
    t = "pts_bbox_head.transformer"
    flat = torch.cat([
        (f.flatten(3).permute(1, 0, 3, 2)
         + w[f"{t}.cams_embeds"][:, None, None, :]
         + w[f"{t}.level_embeds"][None, None, l:l + 1, :])
        for l, f in enumerate(feats)], 2).permute(0, 2, 1, 3)
    return x, flat, shapes


@pytest.mark.parametrize("carried", [False, True])
def test_temporal_self_attention_in_both_forms(setup, carried):
    cfg, w, model, pool = setup
    g = torch.Generator().manual_seed(5)
    Qb, D = cfg["bev_h"] * cfg["bev_w"], cfg["embed_dims"]
    q, pos, prev = (torch.randn(1, Qb, D, generator=g) for _ in range(3))
    refp = ref.ref_2d(cfg, CPU)[None] + torch.tensor([[0.03, -0.05]])
    pair = torch.stack([prev, q], 1) if carried else None
    tsa = model.pts_bbox_head.transformer.encoder.layers[1].attentions[0]
    with torch.no_grad():
        got = tsa(q, pos, pair, refp, (cfg["bev_h"], cfg["bev_w"]))
        want = ref.tsa(w, cfg, "pts_bbox_head.transformer.encoder.layers.1."
                       "attentions.0", q, pos,
                       None if pair is None else pair.reshape(2, Qb, D),
                       torch.stack([refp, refp], 1).reshape(2, Qb, 1, 2),
                       Precision())
    assert rel(got, want) < 1e-5


def test_one_encoder_layer(setup):
    cfg, w, model, pool = setup
    x, flat, shapes = _bev_inputs(cfg, w, pool)
    g = torch.Generator().manual_seed(6)
    Qb, D = cfg["bev_h"] * cfg["bev_w"], cfg["embed_dims"]
    q, pos, prev = (torch.randn(1, Qb, D, generator=g) for _ in range(3))
    refp = ref.ref_2d(cfg, CPU)[None]
    rc, mask = ref.point_sampling(cfg, x["lidar2img"])
    head = model.pts_bbox_head
    ref_cam, hit = head.point_sampling(x["lidar2img"])
    pair = torch.stack([prev, q], 1)
    with torch.no_grad():
        got = head.transformer.encoder.layers[0](
            q, pos, pair, refp, (cfg["bev_h"], cfg["bev_w"]),
            flat.permute(2, 0, 1, 3), shapes, ref_cam, hit)
        want = ref.encoder_layer(w, cfg, 0, q, pos, pair.reshape(2, Qb, D),
                                 torch.stack([refp[:, :, None]] * 2, 1)
                                 .reshape(2, Qb, 1, 2), flat, shapes, rc,
                                 mask, Precision())
    assert rel(got, want) < 1e-4


def test_the_decoder_with_box_refinement(setup):
    cfg, w, model, _ = setup
    g = torch.Generator().manual_seed(8)
    bev = torch.randn(1, cfg["bev_h"] * cfg["bev_w"], cfg["embed_dims"],
                      generator=g)
    with torch.no_grad():
        cls, reg = model.pts_bbox_head.decode(bev)
        want_cls, want_reg = ref.decoder(w, cfg, bev, Precision())
    assert rel(cls, want_cls) < 1e-4 and rel(reg, want_reg) < 1e-4
    # the refinement moves the reference points: later layers' centres
    # differ from the first's by more than rounding
    assert rel(reg[-1, ..., :2], reg[0, ..., :2]) > 1e-3


# ---- the forward and the stream --------------------------------------------

def test_a_scene_with_a_reset_through_the_decode(setup):
    """Three samples, scene ids 0, 0, 1: the second carries the first's
    BEV, the third starts anew. Each against the reference on the same
    inputs (the program's own carried BEV), and the program's decode
    against the reference's decode of the same outputs."""
    cfg, w, model, pool = setup
    telemetry.reset()
    stream = BEVStream(model)
    prev = prev_can = None
    for i, scene in enumerate((0, 0, 1)):
        x = sample(pool, i)
        if scene == 1:
            prev = prev_can = None
        out = stream(x, scene)
        with torch.no_grad():
            r = ref.forward(w, cfg, x, prev, prev_can)
        assert max(ref.output_gaps(out, r).values()) < 1e-4, i
        assert ref.bev_gap(out["bev_embed"], r["bev_embed"]) < 1e-4, i
        dets = petr_decode(out["all_cls_scores"][-1],
                           out["all_bbox_preds"][-1],
                           cfg["post_center_range"], cfg["max_num"])
        mine = ref.decode(out["all_cls_scores"][-1].numpy(),
                          out["all_bbox_preds"][-1].numpy(),
                          cfg["post_center_range"], cfg["max_num"])
        assert ref.decode_mismatch(dets, mine) == 0
        prev, prev_can = out["bev_embed"], x["can_bus"]
    c = telemetry.snapshot()["counters"]
    assert c["bevformer.scene_resets"] == 2
    assert c["bevformer.prev_bev_carried"] == 1
    assert telemetry.snapshot()["spans"]["bevformer.stream"]["count"] == 3


def test_the_carried_bev_changes_the_output(setup):
    """The same sample with and without the previous BEV gives other
    outputs: the carry is not a no-op."""
    cfg, w, model, pool = setup
    x = sample(pool, 1)
    with torch.no_grad():
        first = model(sample(pool, 0))
        alone = model(x)
        carried = model(dict(x, prev_bev=first["bev_embed"],
                             prev_can_bus=pool["can_bus"][:1]))
    assert rel(carried["bev_embed"], alone["bev_embed"]) > 1e-2


def test_the_control_is_far_from_the_reference(setup):
    """The e4m3 control (every product's operands rounded) against f32:
    the gaps it reads at this size, far above the f32 port's."""
    cfg, w, _, pool = setup
    x = sample(pool, 0)
    with torch.no_grad():
        r = ref.forward(w, cfg, x)
        c = ref.forward(w, cfg, x, P=Precision("fp8"))
    assert max(ref.output_gaps(c, r).values()) > 1e-2
    assert ref.bev_gap(c["bev_embed"], r["bev_embed"]) > 1e-2


def test_the_state_dict_is_the_references_layout(setup):
    cfg, w, model, _ = setup
    got = model.state_dict()
    assert set(got) == set(w)
    assert all(got[k].shape == v.shape for k, v in w.items())
    full = json.loads((REPO / "benchmark" / "configs" / "bevformer-base.json")
                      .read_text())
    names = {n for n, _, _ in ref.param_specs(full)}
    assert sum(".conv_offset.weight" in n for n in names) == 26   # DCN
    assert sum(".cls_branches." in n and n.endswith(".0.weight")
               for n in names) == 6                                # unshared


def test_the_entry_point_loads_a_state_dict_strictly(setup):
    cfg, w, model, _ = setup
    assert not model.training
    seeded = build_bevformer_model(program_bevformer.bevformer_config(cfg),
                                   seed=3, device="cpu")
    key = "pts_bbox_head.bev_embedding.weight"
    assert not torch.equal(seeded.state_dict()[key], model.state_dict()[key])
    with pytest.raises(RuntimeError):
        build_bevformer_model(program_bevformer.bevformer_config(cfg),
                              device="cpu",
                              state_dict={k: v for k, v in w.items()
                                          if "cams_embeds" not in k})


def test_the_config_holds_the_published_values():
    c = BEVFormerConfig()
    assert c.padded_size == (1600, 928)
    assert c.level_shapes == ((116, 200), (58, 100), (29, 50), (15, 25))
    assert sum(h * w for h, w in c.level_shapes) * c.num_cams == 184_950
    full = json.loads((REPO / "benchmark" / "configs" / "bevformer-base.json")
                      .read_text())
    assert program_bevformer.bevformer_config(full) == BEVFormerConfig(
        compute_dtype="bfloat16")
    assert [tuple(s) for s in ref.level_shapes(full)] == list(c.level_shapes)


def test_flops_count_the_ports_products(setup):
    cfg, _, model, pool = setup
    # the counter's module hooks refuse views of parameters that require
    # grad (the query embedding's halves): count a frozen copy
    model = copy.deepcopy(model).requires_grad_(False)
    # the math backend, so that the counter sees attention's two products
    with torch.no_grad(), sdpa_kernel(SDPBackend.MATH), \
            FlopCounterMode(display=False) as fc:
        model(sample(pool, 0))
    assert fc.get_total_flops() == bevformer_flops.sample_flops(cfg)
    full = json.loads((REPO / "benchmark" / "configs" / "bevformer-base.json")
                      .read_text())
    assert bevformer_flops.sample_flops(full) / 2e9 == pytest.approx(
        1830.10, abs=0.01)
    assert bevformer_flops.forward_flops(full)["dcn"] / 2e9 == pytest.approx(
        533.67, abs=0.01)
    assert bevformer_flops.msda_bytes(full, 1) == 1_696_651_200


@pytest.fixture
def rec():
    telemetry.reset()
    telemetry.enable(True)
    yield telemetry.RECORDER
    telemetry.enable(True)


def test_bevformer_records_its_init(rec):
    build_bevformer_model(BEVFormerConfig.tiny(), seed=1, device="cpu")
    snap = telemetry.snapshot()
    assert snap["spans"]["models.init"]["count"] == 1
    assert "ms_deform_attn" in launch_counts()


@pytest.mark.parametrize("build", [
    lambda: build_model(ModelConfig.tiny(), seed=0, device="cpu"),
    lambda: build_petr_model(PETRConfig.tiny(), seed=0, device="cpu")],
    ids=["parq", "petr"])
def test_building_parq_or_petr_loads_no_msda_library(monkeypatch, build):
    loaded = []
    monkeypatch.setattr(_build, "load", lambda name: loaded.append(name))
    model = build()
    assert isinstance(model, (PARQModel, PETRModel))
    assert "ms_deform_attn" not in loaded
    assert "ms_deform_attn" not in _build._libs


# ---- the cell's loop and checks at a tiny size ---------------------------

def make_root(tmp: Path) -> Path:
    """`tmp` as a checkout with the benchmark and a tiny BEVFormer cell
    beside the real ones (new files and entries only)."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs" / "tiny-bev.json").write_text(
        json.dumps(tiny_cfg()))
    bench["configs"].append({"name": "tiny-bev", "source": "test",
                             "file": "benchmark/configs/tiny-bev.json",
                             "reduced": [], "why": "CPU test"})
    tr = json.loads((REPO / "benchmark" / "traffic" / "eval-bevformer-b1.json")
                    .read_text())
    tr.update(pool_batches=3, trace_from=0.0, trace_batches=2,
              check_batches=2)
    (tmp / "benchmark" / "traffic" / "tiny-bev.json").write_text(
        json.dumps(tr))
    (tmp / "benchmark" / "limits" / "tiny-bev-eval.json").write_text(
        json.dumps({"output_gap": 1e-4, "bev_gap": 1e-4,
                    "decode_mismatch": 0}))
    bench["workloads"].append({"name": "tiny-bev-eval",
                               "config": "tiny-bev", "traffic": "tiny-bev",
                               "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-bev-eval")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def _run(root, trace=False, seed=2 ** 31 + 9):
    out, _ = run_cell(root, "tiny-bev-eval", seed, 0.5, trace, CPU, 0.0)
    return out


def test_the_cell_runs_correct_and_reads_its_metrics(tmp_path):
    root = make_root(tmp_path)
    out = _run(root)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"eval_frames_per_s", "setup_s"}
    assert set(out["checks"]) == {"output_gap", "bev_gap", "decode_mismatch"}
    assert out["checks"]["output_gap"]["value"] < 1e-5
    out = _run(root, trace=True)
    assert out["correct"]
    # no card: no marks, no kernels, no capture and no copy from a card, so
    # those metrics read nothing; the model's init and the trace's idle
    # share are read on any device
    assert not {"bevformer_fwd_mfu.replay", "msda_roofline.bev",
                "post_fwd_ms.bev", "host_gap_ms.bev", "capture_s.bev",
                "d2h_copies.bev"} & set(out["metrics"])
    assert {"model_init_s.bev", "idle_share.bev"} <= set(out["metrics"])


def test_a_stale_forward_fails_the_cell(tmp_path, monkeypatch):
    """Every call after the second hands back the second call's outputs,
    as a replay whose new inputs never reach the graph would: its BEV is
    not the one the inputs give (the decoder's check runs on the program's
    own BEV and points, so the outputs agree with it)."""
    graphs = importlib.import_module("parq_torch.graphs")
    real = graphs.Graphed.__call__
    calls = []

    def stale(self, *a, **kw):
        calls.append(copy.deepcopy(real(self, *a, **kw)))
        return calls[min(len(calls) - 1, 1)]
    monkeypatch.setattr(graphs.Graphed, "__call__", stale)
    out = _run(make_root(tmp_path))
    assert not out["correct"]
    assert out["checks"]["bev_gap"]["value"] > 1e-3


def test_a_dropped_carry_fails_the_cell(tmp_path, monkeypatch):
    """A stream that keeps the previous BEV but never hands it to the
    forward (every sample run as a scene's first): the carried samples'
    outputs do not follow from the BEV the stream holds."""
    bev = importlib.import_module("parq_torch.models.bevformer")
    real = bev.BEVStream.__call__

    def forgetful(self, sample, scene):
        fn = self.fn
        self.fn = lambda x: fn({k: v for k, v in x.items()
                                if not k.startswith("prev_")})
        try:
            return real(self, sample, scene)
        finally:
            self.fn = fn
    monkeypatch.setattr(bev.BEVStream, "__call__", forgetful)
    out = _run(make_root(tmp_path))
    assert not out["correct"]
    assert out["checks"]["bev_gap"]["value"] > 1e-3


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


def test_the_calibration_reads_program_control_and_drift(tmp_path, capsys):
    """`calibrate_bevformer` over a tiny scene: the f32 program's gaps
    stay at rounding, the control's are far above them, and the f32
    chain does not drift from the reference's own."""
    from benchmark import calibrate_bevformer
    from benchmark.harness import find_cell
    cell = find_cell(make_root(tmp_path), "tiny-bev-eval")
    calibrate_bevformer.forward_cell(cell, [5], {5}, CPU)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    by = {k: [l for l in lines if l["kind"] == k]
          for k in ("program", "control", "drift")}
    assert all(len(v) == 3 for v in by.values())
    assert max(l["output_gap"] for l in by["program"]) < 1e-4
    assert max(l["bev_gap"] for l in by["drift"]) < 1e-4
    assert min(max(l["output_gap"], l["bev_gap"])
               for l in by["control"]) > 1e-2

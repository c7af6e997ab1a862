"""The release dress rehearsal on the port's eval path: the twin of
tests/test_release_rehearsal.py, case for case.

A torch checkpoint in parq_release.ckpt's key layout, written from the
torch oracle's modules (`torch_oracle.release_state_dict`: the dead
decoder-final norm and BatchNorm's `num_batches_tracked` included, the
BatchNorm statistics random), loads strictly through
`parq_torch.train.checkpoint.load_pretrained` into the Trainer that
configs/eval.yaml describes (CONF_THRESH 0.05, the real
data/average_scan2cad.txt, LIMIT_VAL_BATCHES 2, 2 synthetic snippets of one
scene, f32 on the CPU). `Trainer.validate` runs; then against the oracle
on the same snippets:

  * every iteration's five outputs within 1.5e-3·2.8^l (l the iteration),
    sizes compared divided by their own mean row, an argmax flip allowed
    only where the oracle's logit gap is below twice that;
  * the port's F1 dict within 0.15 of the oracle's outputs pushed through
    the port's parse_pred, NMS and F1, and some predictions survive NMS.

The port's LayerNorms keep the JAX package's eps 1e-6 against the
oracle's 1e-5 (ROADMAP §C2), as the JAX rehearsal does. Two sizes:
`small` (release width, 64x48 images, Q=16, L=2; tier 1) and `release`
(the JAX test's dimensions: 3 x 320x240, Q=256, L=8; slow). A third test
holds `parq_torch.tools.release_ckpt`'s file to the oracle's layout.
"""
import numpy as np
import pytest
import torch
import torch.nn as tnn

from test_parity_backbone import (TFPN, TResNet50Body, _oracle_forward,
                                  _randomize_bn_stats)
from torch_oracle import (Dims, TorchDecoder, compose_camera_local,
                          ray_pe_oracle, release_state_dict, scale_camera)

from parq_torch.config import ModelConfig, get_cfg
from parq_torch.config.model import MEAN_SIZE_PATH
from parq_torch.data import SnippetLoader, SyntheticDataset
from parq_torch.evals import F1Calculator, parse_pred, targets_to_gt_list
from parq_torch.geometry import Obb3D, Pose
from parq_torch.losses import parse_targets
from parq_torch.models import PARQModel
from parq_torch.models.box_processor import load_mean_size_table
from parq_torch.train import loop
from parq_torch.train.checkpoint import load_pretrained
from parq_torch.tools.release_ckpt import synthesize_release_checkpoint

import torch_common  # noqa: F401

D, HEADS, FFN, NCLS, B, T = 1024, 4, 768, 9, 1, 3
SCALE = (-3.0, 3.0, -2.0, 0.5, 0.25, 5.25)
MEAN_SIZE = tuple(tuple(float(v) for v in row)
                  for row in load_mean_size_table(MEAN_SIZE_PATH, NCLS))
CONF_THRESH = 0.05  # low so the NMS/F1 chain is non-vacuous at random init
KEYS = ("pred_logits", "center_unnormalized", "size_unnormalized",
        "ortho6d", "coord_pos")
SIZES = {"small": dict(W0=64, H0=48, Q=16, L=2),
         "release": dict(W0=320, H0=240, Q=256, L=8)}


def _dims(size):
    s = SIZES[size]
    return Dims(D=D, HEADS=HEADS, FFN=FFN, L=s["L"], Q=s["Q"], NCLS=NCLS,
                NSAMP=64, SCALE=SCALE, MEAN_SIZE=MEAN_SIZE, B=B, T=T,
                H0=s["H0"], W0=s["W0"])


def _oracle(dims):
    torch.manual_seed(7)
    body = TResNet50Body().eval()
    fpn = TFPN().eval()
    _randomize_bn_stats(body, np.random.RandomState(5))
    enc = tnn.Sequential(tnn.Linear(dims.NSAMP * 3, D), tnn.ReLU(),
                         tnn.Linear(D, D)).eval()
    dec = TorchDecoder(dims).eval()
    return body, fpn, enc, dec


def _eval_cfg(ckpt, tmp_path, dims):
    cfg = get_cfg()
    cfg.merge_from_file("configs/eval.yaml")
    cfg.merge_from_list([
        "CHECKPOINT_PATH", str(ckpt),
        "DATAMODULE.DATA_PATH", "synthetic",
        "MODEL.DECODER.CONF_THRESH", str(CONF_THRESH),
        "MODEL.DECODER.MEAN_SIZE_PATH", MEAN_SIZE_PATH,
        "LOG_IMAGES", "False",
        "TRAINER.LIMIT_VAL_BATCHES", "2",
        "TPU.PLATFORM", "cpu",
        "LOG_PATH", str(tmp_path / "logs"),
        "TPU.IMAGE_SIZE", f"[{dims.W0}, {dims.H0}]",
        "MODEL.DECODER.NUM_QUERIES", str(dims.Q),
        "MODEL.DECODER.TRANSFORMER.DEC_LAYERS", str(dims.L),
    ])
    cfg.freeze()
    return cfg


def _iteration_failures(i, ours_it, theirs_it, L):
    """The JAX rehearsal's per-iteration envelope and size rule."""
    failures = []
    mean_tab = np.asarray(MEAN_SIZE, np.float32)  # (NCLS+1, 3)
    for l in range(L):
        tol = 1.5e-3 * (2.8 ** l)
        for key in KEYS:
            ours = ours_it[key][l]
            theirs = theirs_it[l][key].numpy()
            if key == "size_unnormalized":
                # size = exp(size_scale) x mean_size[argmax cls]: a near-tied
                # argmax flips the mean row, so compare exp(size_scale) (size
                # over its OWN row) and require every flip to be a near-tie
                # of the oracle's own logits
                lo = ours_it["pred_logits"][l]
                lt = theirs_it[l]["pred_logits"].numpy()
                ao, at = lo.argmax(-1), lt.argmax(-1)
                err = np.max(np.abs(ours / mean_tab[ao]
                                    - theirs / mean_tab[at]))
                flips = ao != at
                if flips.any():
                    gap = np.abs(
                        np.take_along_axis(lt, ao[..., None], -1)
                        - np.take_along_axis(lt, at[..., None], -1)
                    )[..., 0][flips]
                    print(f"snippet {i} iter {l} {key}: {int(flips.sum())} "
                          f"argmax flips, worst oracle logit gap "
                          f"{gap.max():.5f}")
                    if not gap.max() < 2 * tol:
                        failures.append(
                            f"snippet {i} iter {l} {key}: argmax flip with "
                            f"logit gap {gap.max()} >= {2 * tol} (not a "
                            "near-tie)")
            else:
                err = np.max(np.abs(ours - theirs))
            print(f"snippet {i} iter {l} {key}: max abs err {err:.5f} "
                  f"(tol {tol:.4f})")
            if not err < tol:
                failures.append(f"snippet {i} iter {l} {key}: {err} >= {tol}")
    return failures


@pytest.mark.parametrize("size", [
    "small", pytest.param("release", marks=pytest.mark.slow)])
def test_release_rehearsal(size, tmp_path, monkeypatch):
    dims = _dims(size)
    body, fpn, enc, dec = _oracle(dims)

    # ---- checkpoint file in the release interchange format --------------
    ckpt = tmp_path / "fake_parq_release.ckpt"
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in release_state_dict(body, fpn, enc, dec).items()}
    torch.save({"state_dict": sd}, str(ckpt))

    # ---- the port's eval path (cli/eval.py's body) ----------------------
    cfg = _eval_cfg(ckpt, tmp_path, dims)
    # one scene, so cross-snippet track association is exercised; the
    # loader's prefetch thread, as the eval twin's
    ds = SyntheticDataset(num_snippets=2, image_size=(dims.W0, dims.H0),
                          seed=1000, scenes=1)
    loader = SnippetLoader(ds, 1, shuffle=False, drop_last=False)
    trainer = loop.Trainer(cfg)
    trainer.setup_state(steps_per_epoch=1)
    load_pretrained(trainer.model, cfg.CHECKPOINT_PATH, strict=True)

    captured = []
    orig_step = trainer.eval_step_fn

    def capture_step(*a, **k):
        losses, outputs = orig_step(*a, **k)
        captured.append({k: v.numpy().copy() for k, v in outputs.items()})
        return losses, outputs

    monkeypatch.setattr(trainer, "eval_step_fn", capture_step)
    metrics = trainer.validate(loader,
                               limit_batches=cfg.TRAINER.LIMIT_VAL_BATCHES)
    assert len(captured) == 2
    assert np.isfinite(metrics["total_loss"])

    # ---- the torch oracle over the same snippets ------------------------
    calc = F1Calculator(CONF_THRESH, num_semcls=NCLS)
    loader.position = 0
    n = 0
    for i, batch in enumerate(loader):
        n += 1
        cam = np.asarray(batch["camera"])
        cam_feat = scale_camera(cam, 0.25)
        Tcl = compose_camera_local(
            np.asarray(batch["T_camera_pseudoCam"]),
            np.asarray(batch["T_world_pseudoCam"]),
            np.asarray(batch["T_world_local"]))
        imgs = np.asarray(batch["rgb_img"], np.float32)
        with torch.no_grad():
            feats = _oracle_forward(
                body, fpn, torch.from_numpy(
                    imgs.reshape(B * T, dims.H0, dims.W0, 3))
                .permute(0, 3, 1, 2))
            feats = feats.permute(0, 2, 3, 1).reshape(
                B, T, dims.H, dims.W, D)
            memory = feats + ray_pe_oracle(enc, cam_feat, Tcl, dims)
            outs = dec(memory,
                       torch.from_numpy(Tcl[..., :9].reshape(B, T, 3, 3)),
                       torch.from_numpy(Tcl[..., 9:]),
                       tuple(cam_feat[0, 0]))

        # (a) every iteration's outputs
        failures = _iteration_failures(i, captured[i], outs, dims.L)
        assert not failures, "\n".join(failures)

        # (b) the oracle's outputs through the port's host NMS/F1 chain
        last = {k: outs[-1][k] for k in KEYS}
        last["sem_cls_prob"] = torch.softmax(outs[-1]["pred_logits"], -1)
        Twl = torch.from_numpy(np.asarray(batch["T_world_local"],
                                          np.float32))
        host = parse_pred(last, Twl, tuple(cfg.MODEL.DECODER.TRACK_SCALE),
                          NCLS, enable_nms=True)
        host["scene_name"] = batch["scene_name"]
        targets = parse_targets(
            Obb3D(torch.from_numpy(np.asarray(batch["obbs_padded"],
                                              np.float32))),
            Pose(Twl), torch.from_numpy(np.asarray(batch["sym"])))
        calc.step(host, targets_to_gt_list(targets))
    assert n == 2

    # Both chains run the same host NMS/F1 code: this holds the chain's
    # sensitivity to the forward drift above. Non-vacuity: the low
    # threshold yields predictions through NMS.
    assert calc.preds, "the oracle-fed chain produced no predictions"
    oracle_metrics = calc.compute_metrics(verbose=False)
    assert set(oracle_metrics) <= set(metrics)
    for key, val in oracle_metrics.items():
        assert metrics[key] == pytest.approx(val, abs=0.15), (
            f"F1-chain mismatch at {key}: port {metrics[key]} vs "
            f"oracle-fed {val}")


def test_synthesized_checkpoint_has_the_release_layout(tmp_path):
    """`synthesize_release_checkpoint` writes the oracle's release layout:
    the same keys, shapes and dtypes (dead norm and BatchNorm counters
    included), non-trivial BatchNorm statistics, nothing but
    {"state_dict"}; the port's release model loads it strictly."""
    body, fpn, enc, dec = _oracle(_dims("release"))
    want = {k: torch.from_numpy(np.asarray(v))
            for k, v in release_state_dict(body, fpn, enc, dec).items()}
    path = synthesize_release_checkpoint(str(tmp_path / "fake.ckpt"), seed=3)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert list(blob) == ["state_dict"]
    got = blob["state_dict"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (tuple(got[k].shape), got[k].dtype) == \
            (tuple(v.shape), v.dtype), k
    means = [v for k, v in got.items() if k.endswith("running_mean")]
    varis = [v for k, v in got.items() if k.endswith("running_var")]
    assert means and all(float(m.abs().max()) > 0 for m in means)
    assert all(float((v - 1).abs().max()) > 0 for v in varis)

    model = PARQModel(ModelConfig()).eval()
    load_pretrained(model, path, strict=True)
    own = model.state_dict()
    assert all(torch.equal(own[k], got[k]) for k in own)
    again = synthesize_release_checkpoint(str(tmp_path / "again.ckpt"),
                                          seed=3)
    same = torch.load(again, map_location="cpu",
                      weights_only=True)["state_dict"]
    assert all(torch.equal(same[k], got[k]) for k in got)

"""The port's full model against the torch oracle of the reference
(tests/torch_oracle.py: standard torch layers, reference semantics), in
the release checkpoint's key layout, f32 on the CPU, at the width of
tests/test_parity_full_model.py (ResNet50-FPN, C = D = 1024, 4 heads, FFN
768) with tiny images, 16 queries and 2 iterations:

- the oracle's modules export to the release key layout
  (`release_state_dict`) and load into the port strictly (the dead
  decoder-final norm dropped, as `load_pretrained` drops it, and torch
  BatchNorm's `num_batches_tracked` counters, which a frozen BatchNorm has
  no use for);
- the forward (every output of every iteration) within atol 4e-3, rtol
  2e-3, the tolerance of the JAX package's end-to-end oracle test;
- the gradients of one scalar of the outputs with respect to every
  parameter, parameter by parameter: ‖Δ‖ ≤ 1e-2·‖g‖ + 1e-5·‖G‖.

The port's LayerNorms use flax's eps 1e-6, as the JAX package does; the
oracle (like the reference) uses torch's 1e-5, and the test sets the
port's to 1e-5. The oracle resizes the FPN levels with `F.interpolate`,
the port with its own bilinear resize; at BACKBONE2D.LAYER 0 the levels
only grow, where the two agree.
"""
import numpy as np
import pytest
import torch
import torch.nn as tnn

from test_parity_backbone import (TFPN, TResNet50Body, _oracle_forward,
                                  _randomize_bn_stats)
from torch_oracle import (Dims, TorchDecoder, ray_pe_oracle, scale_camera,
                          release_state_dict)

from parq_torch.config import ModelConfig
from parq_torch.models import PARQModel
from parq_torch.train.checkpoint import DEAD_PREFIX

import torch_common  # noqa: F401

D, HEADS, FFN, L, Q, NCLS = 1024, 4, 768, 2, 16, 9
B, T, H0, W0 = 1, 2, 48, 64
H, W = H0 // 4, W0 // 4
NSAMP = 64
SCALE = (-3.0, 3.0, -2.0, 0.5, 0.25, 5.25)
MEAN_SIZE = tuple(tuple(float(v) for v in row)
                  for row in np.linspace(0.5, 1.5, (NCLS + 1) * 3)
                  .reshape(NCLS + 1, 3))
DIMS = Dims(D=D, HEADS=HEADS, FFN=FFN, L=L, Q=Q, NCLS=NCLS, NSAMP=NSAMP,
            SCALE=SCALE, MEAN_SIZE=MEAN_SIZE, B=B, T=T, H0=H0, W0=W0)
KEYS = ("pred_logits", "center_unnormalized", "size_unnormalized",
        "ortho6d", "coord_pos")


def _oracle_params(body, fpn, enc, dec):
    """{release key: parameter} of the oracle's modules (the parameters of
    `release_state_dict`'s layout)."""
    out = {}
    dpre = "box3d_decoder.parq_module.decoder"
    hpre = "box3d_decoder.mlp_heads"
    mods = {"backbone2d.resnet_fpn.body": body,
            "backbone2d.resnet_fpn.fpn": fpn, "add_ray_pe.encoder": enc,
            f"{dpre}.position_encoder.0": dec.pos_enc[0],
            f"{dpre}.position_encoder.2": dec.pos_enc[2],
            f"{dpre}.layers.0.self_attn": dec.self_attn,
            f"{dpre}.layers.0.multihead_attn": dec.cross_attn,
            f"{dpre}.layers.0.linear1": dec.linear1,
            f"{dpre}.layers.0.linear2": dec.linear2,
            f"{dpre}.layers.0.norm1": dec.norm1,
            f"{dpre}.layers.0.norm2": dec.norm2,
            f"{dpre}.layers.0.norm3": dec.norm3,
            f"{hpre}.sem_cls_head.layers.0": dec.sem_cls_head,
            f"{hpre}.size_head.layers.0": dec.size_head,
            f"{hpre}.center_head.layers": dec.center_head,
            f"{hpre}.rotation_head.layers": dec.rotation_head}
    for prefix, mod in mods.items():
        for k, p in mod.named_parameters():
            out[f"{prefix}.{k}"] = p
    out["box3d_decoder.refpoint.weight"] = dec.refpoint.weight
    return out


def _scalar(outs):
    """One scalar of every output of every iteration (fixed weights)."""
    total = 0.0
    for l, o in enumerate(outs):
        for i, k in enumerate(KEYS):
            total = total + ((l + 1) * (i + 1) * 0.1) * (o[k] ** 2).mean()
    return total


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    torch.manual_seed(11)
    body, fpn = TResNet50Body().eval(), TFPN().eval()
    _randomize_bn_stats(body, np.random.RandomState(3))
    enc = tnn.Sequential(tnn.Linear(NSAMP * 3, D), tnn.ReLU(),
                         tnn.Linear(D, D)).eval()
    dec = TorchDecoder(DIMS).eval()
    port = PARQModel(ModelConfig(
        image_size=(W0, H0), num_views=T, num_samples=NSAMP, dec_layers=L,
        num_queries=Q, num_semcls=NCLS, scale=SCALE, ray_points_scale=SCALE,
        dropout_rate=0.0)).eval()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          release_state_dict(body, fpn, enc, dec).items()
          if not k.startswith(DEAD_PREFIX)
          and not k.endswith("num_batches_tracked")}
    port.load_state_dict(sd, strict=True)
    port.box3d_decoder.mean_size.copy_(torch.tensor(MEAN_SIZE))
    layer = port.box3d_decoder.parq_module.decoder.layers[0]
    for norm in (layer.norm1, layer.norm2, layer.norm3):
        norm.eps = 1e-5

    imgs = rng.rand(B, T, H0, W0, 3).astype(np.float32)
    cam = np.tile(np.array([W0, H0, 40.0, 40.0, W0 / 2, H0 / 2],
                           np.float32), (B, T, 1))
    Tcps = []
    for t in range(T):
        th = 0.12 * t
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]], np.float32)
        Tcps.append(np.concatenate([R.reshape(9), [0.1 * t, -0.05, 0.1]]))
    Tcp = np.broadcast_to(np.stack(Tcps).astype(np.float32),
                          (B, T, 12)).copy()
    ident = np.tile(np.concatenate([np.eye(3, dtype=np.float32).reshape(9),
                                    np.zeros(3, np.float32)]), (B, T, 1))

    def oracle_forward():
        cam_feat = scale_camera(cam, 0.25)
        feats = _oracle_forward(body, fpn, torch.from_numpy(
            imgs.reshape(B * T, H0, W0, 3)).permute(0, 3, 1, 2))
        feats = feats.permute(0, 2, 3, 1).reshape(B, T, H, W, D)
        with torch.enable_grad():
            # ray_pe_oracle runs the encoder under no_grad: recompute it
            # with a gradient from the same inputs
            logit = _ray_logits(cam_feat, Tcp)
        encoding = enc(logit)
        memory = feats + encoding
        R_cl = torch.from_numpy(Tcp[..., :9].reshape(B, T, 3, 3))
        t_cl = torch.from_numpy(Tcp[..., 9:])
        assert torch.allclose(encoding, ray_pe_oracle(enc, cam_feat, Tcp,
                                                      DIMS))
        return dec(memory, R_cl, t_cl, tuple(cam_feat[0, 0]))

    batch = {"rgb_img": torch.from_numpy(imgs),
             "camera": torch.from_numpy(cam),
             "T_camera_pseudoCam": torch.from_numpy(Tcp),
             "T_world_pseudoCam": torch.from_numpy(ident),
             "T_world_local": torch.from_numpy(ident[:, :1].copy())}
    return (body, fpn, enc, dec), port, oracle_forward, batch


def _ray_logits(cam_feat, Tcp):
    """The encoder's input of `ray_pe_oracle` (its numpy part)."""
    captured = {}

    class Capture(tnn.Module):
        def forward(self, x):
            captured["x"] = x
            return x

    ray_pe_oracle(Capture(), cam_feat, Tcp, DIMS)
    return captured["x"]


def test_forward_matches_the_torch_oracle(models):
    _, port, oracle_forward, batch = models
    with torch.no_grad():
        want = oracle_forward()
        got = port(batch)
    for l in range(L):
        for k in KEYS:
            np.testing.assert_allclose(got[k][l].numpy(), want[l][k].numpy(),
                                       atol=4e-3, rtol=2e-3,
                                       err_msg=f"iteration {l} {k}")


def test_gradients_match_the_torch_oracle(models):
    oracle_mods, port, oracle_forward, batch = models
    params = _oracle_params(*oracle_mods)
    for p in list(params.values()) + list(port.parameters()):
        p.grad = None
    _scalar(oracle_forward()).backward()
    got = port(batch)
    _scalar([{k: got[k][l] for k in KEYS} for l in range(L)]).backward()
    # the oracle's BatchNorm scales are parameters; the port's frozen
    # BatchNorm holds them as buffers, as the reference's does
    port_params = dict(port.named_parameters())
    want = {k: p.grad for k, p in params.items()
            if p.grad is not None and k in port_params}
    assert sorted(want) == sorted(k for k, p in port_params.items()
                                  if p.grad is not None)
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in want.values())))
    for k, g in want.items():
        d = float((port_params[k].grad - g).norm())
        assert d <= 1e-2 * float(g.norm()) + 1e-5 * total, \
            f"{k}: |Δ|={d} |g|={float(g.norm())} |G|={total}"

"""Two places where the port parts from the JAX package or the reference on
purpose, pinned:

- BACKBONE2D.FREEZE freezes: the backbone's parameters are kept out of
  AdamW, so a step leaves them bit for bit as they were. The JAX package
  hands every parameter to optax (parq_tpu/train/train_step.py:43-47), so
  its frozen backbone still decays by lr·wd a step.
- BACKBONE2D.LAYER ≥ 1 shrinks the larger FPN levels with an antialiased
  bilinear filter, as `jax.image.resize` does (the JAX package's resize),
  where the reference's `F.interpolate` does not antialias. The port's
  resize equals JAX's to 1e-5 and differs from the reference's by far more.
"""
import argparse
import os

import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from parq_tpu.models.resnet_fpn import upsample_linear

from parq_torch.config import ModelConfig, get_cfg, update_config
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.models import build_model
from parq_torch.models.resnet_fpn import _resize
from parq_torch.train.train_step import make_optimizer, train_step

import torch_common  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_freeze_keeps_the_backbone_bit_equal():
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"),
        opts=["MODEL.BACKBONE2D.FREEZE", "True",
              "MODEL.DECODER.TRANSFORMER.DROPOUT_RATE", "0.0"]))
    mcfg = ModelConfig.from_cfg(cfg)
    model = build_model(mcfg, seed=0, device="cpu").train()
    opt = make_optimizer(model, lr=1e-2, weight_decay=0.5)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    frozen = [n for n in before if n.startswith("backbone2d.")]
    assert frozen
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert all(id(p) not in in_opt for n, p in model.named_parameters()
               if n in frozen)
    keys = ("rgb_img", "camera", "T_camera_pseudoCam", "T_world_pseudoCam",
            "T_world_local", "obbs_padded", "sym")
    batch = to_device(make_batch([0], image_size=mcfg.image_size), keys,
                      "cpu")
    train_step(model, opt, batch, torch.Generator().manual_seed(0))
    after = dict(model.named_parameters())
    for n in frozen:
        assert torch.equal(after[n], before[n]), n
    assert any(not torch.equal(after[n], before[n]) for n in before
               if n.startswith("box3d_decoder."))


def test_layer1_shrink_is_jax_resize_not_the_references():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 24, 32).astype(np.float32)       # NCHW, level 0
    h, w = 12, 16                                        # level 1's size
    got = _resize(torch.from_numpy(x), (h, w), "bilinear").numpy()
    want = np.asarray(upsample_linear(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                      h, w)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ref = F.interpolate(torch.from_numpy(x), size=(h, w), mode="bilinear",
                        align_corners=False, antialias=False).numpy()
    assert np.abs(got - ref).max() > 0.1      # the reference's filter differs

"""The port's config tree against the JAX package's (parq_tpu/config).

- the port's YAML reader equals `yaml.safe_load` on every configs/*.yaml
  and on a few scalars, and raises on YAML it does not cover;
- `get_cfg` + `update_config` on each file with overrides gives the JAX
  package's `to_dict()`; `check_config` raises where the JAX one does, with
  the same message;
- the card-support check and the platform switch;
- `ModelConfig.from_cfg(smoke)`, with BACKBONE2D.LAYER 0 and 1 and FREEZE:
  the port's forward with the weights of a JAX `PARQModel.from_config`
  init equals JAX's to 2e-4 (f32, CPU); with FREEZE no gradient reaches
  the backbone.
"""
import argparse
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from parq_tpu.config import check_config as j_check_config
from parq_tpu.config import get_cfg as j_get_cfg
from parq_tpu.config import update_config as j_update_config
from parq_tpu.models import PARQModel as JPARQModel
from parq_tpu.train.train_step import LossConfig as JLossConfig

from parq_torch.config import (ModelConfig, check_card_support, check_config,
                               get_cfg, load_yaml, platform_device,
                               update_config)
from parq_torch.config.node import YamlSubsetError
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.io.from_jax import state_dict_from_flax
from parq_torch.models import BATCH_KEYS, PARQModel
from parq_torch.train.train_step import LossConfig, forward_and_loss

from torch_common import jax_forward, jax_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
# the tiny model's conv rounding through the ResNet and 2 iterations (as
# tests/test_torch_model.py)
ATOL = 2e-4


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1e-4\nb: 1.5e-3\nc: 1.0\nd: -2\ne: .5\nf: 3.\n",
    "a: ~\nb: None\nc: null\nd:\ne: 'x # y'\nf: \"q\"\n",
    "A:\n  B:\n    C: [1, -2.5, 'x', True, ~]\n  D: False\nE: []\n",
    "a: ./data/x.txt  # trailing comment\n# whole line\nb: resnet50\n",
])
def test_yaml_reader_scalars_equal_safe_load(text):
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n", "a: &x 1\n", "a: yes\n", "a: 0x1f\n",
    "a:\n\tb: 1\n", "a: {b: 1}\n", "a: [[1], 2]\n", "a: |\n  text\n",
    "a: 1\n b: 2\n", "---\na: 1\n",
])
def test_yaml_reader_rejects_what_it_does_not_cover(text):
    with pytest.raises(YamlSubsetError):
        load_yaml(text)


OVERRIDES = ["TRAINER.MAX_EPOCHS", "3", "OPTIMIZER.LEARNING_RATE", "2e-4",
             "DATAMODULE.DATA_PATH", "synthetic", "TPU.IMAGE_SIZE", "[32,24]",
             "TRAINER.PRECISION", "16", "MODEL.DECODER.CONF_THRESH", "0.3"]


@pytest.mark.parametrize("opts", [None, OVERRIDES], ids=["file", "overrides"])
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_update_config_equals_jax(path, opts):
    args = argparse.Namespace(cfg=path, opts=opts)
    want, got = j_get_cfg(), get_cfg()
    j_update_config(want, args)
    update_config(got, args)
    assert got.to_dict() == want.to_dict()
    assert got.is_frozen()


def test_unknown_override_key_rejected():
    cfg = get_cfg()
    with pytest.raises(KeyError, match="Unknown config key"):
        cfg.merge_from_list(["TRAINER.NO_SUCH_KEY", "1"])


@pytest.mark.parametrize("section, values", [
    ("TRAINER", {"PRECISION": 64}),
    ("TRAINER", {"RELOAD_DATALOADERS_EVERY_N_EPOCHS": 2}),
    ("TRAINER", {"AUTO_SCALE_BATCH_SIZE": "power"}),
    ("TRAINER", {"CHECK_VAL_EVERY_N_EPOCH": 0}),
    ("TPU", {"SEQ_PARALLEL": True}),
    ("TPU", {"SEQ_PARALLEL": True, "MESH_MODEL": 2,
             "USE_FLASH_CROSS_ATTN": False}),
])
def test_check_config_rejects_as_jax(section, values):
    msgs = []
    for cfg, check in ((j_get_cfg(), j_check_config),
                       (get_cfg(), check_config)):
        cfg[section].update(values)
        with pytest.raises(ValueError) as e:
            check(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_check_config_precision_16_selects_bf16():
    cfg = get_cfg()
    cfg.TRAINER.PRECISION = 16
    check_config(cfg)
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"


def _set(cfg, path, value):
    node = cfg
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


@pytest.mark.parametrize("path, value", [
    (("TPU", "REMAT"), True), (("TPU", "DEBUG_NANS"), True),
    (("TPU", "PARAM_DTYPE"), "bfloat16"),
    (("MODEL", "DECODER", "TRANSFORMER", "SHARE_WEIGHTS"), False),
])
def test_card_support_rejects_levers_not_ported(path, value):
    """No lever is refused any more: REMAT, DEBUG_NANS and SHARE_WEIGHTS
    are honoured, PARAM_DTYPE (read nowhere by the JAX package) is a
    logged lever. Each is accepted on configs/scaled_recurrence.yaml,
    which sets REMAT itself, and the model config follows the first and
    the last."""
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "scaled_recurrence.yaml"),
        opts=None))
    assert cfg.TPU.REMAT is True
    cfg.defrost()
    _set(cfg, path, value)
    check_card_support(cfg)
    check_config(cfg)
    mcfg = ModelConfig.from_cfg(cfg)
    assert mcfg.remat is True and mcfg.num_views == 6
    assert mcfg.dec_layers == 16
    assert mcfg.share_weights == (path[-1] != "SHARE_WEIGHTS")


@pytest.mark.parametrize("settings", [
    {("TPU", "MESH_MODEL"): 2},
    {("TPU", "SEQ_PARALLEL"): True, ("TPU", "MESH_MODEL"): 2},
    {("TPU", "MESH_DATA"): 4}, {("TRAINER", "NUM_NODES"): 2},
])
def test_card_support_accepts_parallel_levers(settings):
    """The (data, model) grid, sequence parallelism and several nodes run
    on the card (parallel/, under torchrun)."""
    cfg = get_cfg()
    for path, value in settings.items():
        _set(cfg, path, value)
    check_card_support(cfg)
    check_config(cfg)


def test_card_support_accepts_tpu_levers():
    """smoke.yaml turns the Pallas sampler off: on the card that is a TPU
    lever with no meaning, accepted (the kernels always run)."""
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"), opts=None))
    assert cfg.TPU.USE_PALLAS_SAMPLER is False
    check_card_support(cfg)
    for name in ("MESH_DATA",):
        cfg.defrost()
        cfg.TPU[name] = 1
        check_card_support(cfg)


def test_platform_device(monkeypatch):
    cfg = get_cfg()
    monkeypatch.delenv("PARQ_PLATFORM", raising=False)
    assert platform_device(cfg) == "cuda"
    cfg.TPU.PLATFORM = "cpu"
    assert platform_device(cfg) == "cpu"
    cfg.TPU.PLATFORM = ""
    monkeypatch.setenv("PARQ_PLATFORM", "cpu")
    assert platform_device(cfg) == "cpu"
    monkeypatch.setenv("PARQ_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PLATFORM"):
        platform_device(cfg)


def smoke_cfgs(*opts):
    args = argparse.Namespace(cfg=os.path.join(ROOT, "configs", "smoke.yaml"),
                              opts=list(opts) or None)
    jcfg, cfg = j_get_cfg(), get_cfg()
    j_update_config(jcfg, args)
    update_config(cfg, args)
    return jcfg, cfg


def test_loss_config_from_cfg_equals_jax():
    jcfg, cfg = smoke_cfgs("MODEL.DECODER.LOSS_WEIGHT", "[1.0, 2.0, 3.0, 4.0]")
    want = JLossConfig.from_config(jcfg)
    got = LossConfig.from_cfg(cfg)
    assert got.loss_weight == tuple(want.loss_weight)
    assert got.num_semcls == want.num_semcls


@functools.lru_cache(maxsize=1)
def jax_init_variables(seed=0):
    """One JAX init of the smoke model, FrozenBN statistics randomized:
    BACKBONE2D.LAYER and FREEZE change no parameter's shape."""
    jcfg, _ = smoke_cfgs()
    jmodel = JPARQModel.from_config(jcfg)
    batch = make_batch([0], image_size=tuple(jmodel.image_size))
    variables = jax_init(jmodel, jax.random.PRNGKey(seed),
                         {k: jnp.asarray(batch[k]) for k in BATCH_KEYS})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(seed + 1)
    variables["frozen"] = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape).astype(np.float32) + 0.5),
        variables["frozen"])
    return variables


def port_from_jax_init(jcfg, cfg, batch_size=2):
    """(port model with the weights of JAX's init, JAX model, its
    variables, numpy batch)."""
    jmodel = JPARQModel.from_config(jcfg)
    mcfg = ModelConfig.from_cfg(cfg)
    assert mcfg.image_size == tuple(jmodel.image_size)
    assert mcfg.feat_size == tuple(jmodel.feat_size)
    batch = make_batch(list(range(batch_size)), image_size=mcfg.image_size)
    variables = jax_init_variables()
    port = PARQModel(mcfg)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return port.eval(), jmodel, variables, batch


@pytest.mark.parametrize("layer, freeze", [(0, False), (1, True)])
def test_from_cfg_forward_equals_jax(layer, freeze):
    opts = ("MODEL.BACKBONE2D.LAYER", str(layer),
            "MODEL.BACKBONE2D.FREEZE", str(freeze))
    jcfg, cfg = smoke_cfgs(*opts)
    port, jmodel, variables, batch = port_from_jax_init(jcfg, cfg)
    want = jax_forward(jmodel, variables, batch)
    with torch.no_grad():
        got = port(to_device(batch, BATCH_KEYS, "cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=ATOL, rtol=ATOL, err_msg=k)


def test_freeze_stops_backbone_gradients():
    _, cfg = smoke_cfgs("MODEL.BACKBONE2D.FREEZE", "True",
                        "MODEL.DECODER.TRANSFORMER.DROPOUT_RATE", "0.0")
    port = PARQModel(ModelConfig.from_cfg(cfg))
    batch = make_batch([0, 1], image_size=tuple(cfg.TPU.IMAGE_SIZE))
    keys = BATCH_KEYS + ("obbs_padded", "sym")
    losses, _ = forward_and_loss(port, to_device(batch, keys, "cpu"),
                                 torch.Generator().manual_seed(0))
    losses["total_loss"].backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    backbone = [n for n in grads if n.startswith("backbone2d.")]
    assert backbone and all(grads[n] is None or not grads[n].any()
                            for n in backbone)
    assert any(g is not None and g.any() for n, g in grads.items()
               if n.startswith("box3d_decoder."))

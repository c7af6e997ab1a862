"""The port's `torch.export` artifact (parq_torch/export.py) on the CPU, on
configs/smoke.yaml, with the weights of a JAX init:

- saved and loaded again, the artifact's outputs equal the live model's to
  1e-5, as tests/test_export.py holds JAX's artifact to its live model;
  the program keeps B1 and B2 as the custom ops ``parq::sample_views`` and
  ``parq::flash_kv_fused``, once per decoder iteration each;
- on the same batch it equals JAX's artifact (scripts/export_model.py's
  `export_forward`) to 2e-4, the tiny model's JAX tolerance
  (tests/test_torch_model.py);
- the CLI writes an artifact that `load_artifact` reads.
"""
import argparse
import io
import os

import jax
import numpy as np
import pytest
import torch
from jax import export as jexport

from parq_tpu.config import get_cfg as j_get_cfg

from parq_torch.config import ModelConfig, get_cfg, update_config
from parq_torch.export import (export_forward, load_artifact, load_model,
                               main)
from parq_torch.io.from_jax import state_dict_from_flax
from parq_torch.models import BATCH_KEYS

import torch_common  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "smoke.yaml")
BATCH = 2


def smoke_cfg():
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(cfg=SMOKE,
                                          opts=["TPU.PLATFORM", "cpu"]))
    return cfg


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """JAX's artifact and its init's weights, written as a reference-layout
    state_dict; the port's artifact of the same weights."""
    from scripts.export_model import export_forward as j_export_forward
    jcfg = j_get_cfg()
    jcfg.defrost()
    jcfg.merge_from_file(SMOKE)
    jcfg.freeze()
    jblob, variables, jbatch = j_export_forward(jcfg, batch_size=BATCH)
    path = str(tmp_path_factory.mktemp("export") / "jax_init.pt")
    torch.save(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, variables)), path)
    cfg = smoke_cfg()
    blob, state, batch = export_forward(cfg, BATCH, checkpoint=path,
                                        device="cpu")
    return dict(cfg=cfg, path=path, blob=blob, state=state, batch=batch,
                jblob=jblob, variables=variables, jbatch=jbatch)


def test_artifact_round_trip_equals_live_model(exported):
    ep = torch.export.load(io.BytesIO(exported["blob"]))
    ops = {}
    for mod in ep.graph_module.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for n in mod.graph.nodes:
            if n.op == "call_function" and str(n.target).startswith("parq."):
                ops[str(n.target)] = ops.get(str(n.target), 0) + 1
    L = ModelConfig.from_cfg(exported["cfg"]).dec_layers
    assert ops == {"parq.sample_views.default": L,
                   "parq.flash_kv_fused.default": L}
    cfg = exported["cfg"]
    live = load_model(ModelConfig.from_cfg(cfg), int(cfg.SEED),
                      exported["path"], "cpu")
    for k, v in live.state_dict().items():
        assert torch.equal(exported["state"][k], v), k
    with torch.no_grad():
        got = load_artifact(exported["blob"])(exported["batch"])
        want = live(exported["batch"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_artifact_equals_jax_artifact(exported):
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(exported["batch"][k].numpy(),
                                      np.asarray(exported["jbatch"][k]))
    want = jexport.deserialize(exported["jblob"]).call(
        exported["variables"], exported["jbatch"])
    with torch.no_grad():
        got = load_artifact(exported["blob"])(exported["batch"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=2e-4, rtol=2e-4, err_msg=k)


def test_export_cli_writes_a_loadable_artifact(tmp_path, capsys):
    """One iteration and one view keep the trace short; the written file
    loads and runs on a batch of its shapes."""
    out = str(tmp_path / "fwd.pt2")
    main(["--cfg", SMOKE, "--out", out, "--batch", "1", "TPU.PLATFORM",
          "cpu", "MODEL.DECODER.TRANSFORMER.DEC_LAYERS", "1",
          "DATAMODULE.NUM_FRAMES_PER_SNIPPET", "1"])
    assert "exported" in capsys.readouterr().out
    from parq_torch.export import example_batch
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(cfg=SMOKE, opts=[
        "MODEL.DECODER.TRANSFORMER.DEC_LAYERS", "1",
        "DATAMODULE.NUM_FRAMES_PER_SNIPPET", "1"]))
    batch = example_batch(ModelConfig.from_cfg(cfg), 1, "cpu")
    with torch.no_grad():
        got = load_artifact(out)(batch)
    assert got["pred_logits"].shape[:3] == (1, 1, 16)
    assert all(torch.isfinite(v).all() for v in got.values()
               if v.is_floating_point())

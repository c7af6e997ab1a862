"""The port's HTTP serving (parq_torch/serve.py) on the CPU: /healthz,
/spec and a padded /detect over a real socket; its detections equal JAX
parse_pred on the JAX model's outputs with the same weights. From a
config (configs/smoke.yaml) with a reference-layout checkpoint the test
writes, loaded strictly: the live Engine and the Engine serving a
`torch.export` artifact give the detections of scripts/serve.py's Engine
on the same file, to 1e-4, and the score threshold is the config's
CONF_THRESH."""
import argparse
import dataclasses
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.config import get_cfg as j_get_cfg
from parq_tpu.config import update_config as j_update_config
from parq_tpu.evals.parse_pred import parse_pred as j_parse_pred

from parq_torch.config import ModelConfig, ServeConfig, get_cfg, update_config
from parq_torch.data.synthetic import make_batch
from parq_torch.export import export_forward
from parq_torch.models import BATCH_KEYS, build_model
from parq_torch.serve import Engine, build_server

from torch_common import (jax_forward, jax_tiny_model, jax_variables,
                          randomize_frozen_bn)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH = 2   # served batch; requests send B=1 (the padding path)
# random-init scores are arbitrary: keep every box that survives NMS
CFG = ServeConfig(model=ModelConfig.tiny(), conf_thresh=0.0)
SEED = 3    # weights whose boxes for the request below pass the track scale


@pytest.fixture(scope="module")
def server():
    srv = build_server(Engine(CFG, batch_size=BATCH, device="cpu", seed=SEED))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _url(srv, path):
    host, port = srv.server_address
    return f"http://{host}:{port}{path}"


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(srv, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(_url(srv, "/detect"), data=buf.getvalue(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jax_detections(engine, request):
    """JAX model + JAX parse_pred on the padded request, same weights."""
    jmodel = jax_tiny_model(CFG.model)
    padded = {k: np.concatenate([request[k]] * BATCH) for k in BATCH_KEYS}
    variables = jax_variables(jmodel, engine.model, padded)
    out = jax_forward(jmodel, variables, padded)
    last = {k: v[-1] for k, v in out.items()}
    host = j_parse_pred(last, jnp.asarray(padded["T_world_local"]),
                        CFG.track_scale, CFG.model.num_semcls,
                        enable_nms=True)
    keep = np.where(host["pred_mask"][0]
                    & (host["scores"][0] >= CFG.conf_thresh))[0]
    center = np.asarray(last["center_unnormalized"])[0]
    return [(int(host["labels"][0, k]), float(host["scores"][0, k]),
             center[k], host["corners_world"][0, k]) for k in keep]


def test_healthz_and_spec(server):
    assert _get(server, "/healthz") == (200, {"status": "ok"})
    status, spec = _get(server, "/spec")
    assert status == 200 and spec["batch_size"] == BATCH
    W, H = CFG.model.image_size
    assert spec["inputs"]["rgb_img"]["shape"] == [BATCH, 3, H, W, 3]
    assert sorted(spec["inputs"]) == sorted(BATCH_KEYS)


def test_padded_detect_matches_jax(server):
    batch = make_batch([11], image_size=CFG.model.image_size)
    request = {k: batch[k] for k in BATCH_KEYS}
    status, body = _post(server, request)
    assert status == 200, body
    assert len(body["detections"]) == 1          # padding dropped
    got = body["detections"][0]
    want = _jax_detections(server.engine, request)
    assert len(want) > 0                          # not vacuous
    assert [d["label"] for d in got] == [w[0] for w in want]
    for d, (_, score, center, corners) in zip(got, want):
        np.testing.assert_allclose(d["score"], score, atol=1e-4)
        np.testing.assert_allclose(d["center"], center, atol=1e-4)
        np.testing.assert_allclose(d["corners_world"], corners, atol=1e-4)


def test_detect_rejects_bad_requests(server):
    batch = make_batch([0], image_size=CFG.model.image_size)
    bad = {k: batch[k] for k in BATCH_KEYS}
    bad["camera"] = bad["camera"][:, :2]
    assert _post(server, bad)[0] == 400
    big = make_batch([0, 1, 2], image_size=CFG.model.image_size)
    assert _post(server, {k: big[k] for k in BATCH_KEYS})[0] == 400
    missing = {k: batch[k] for k in BATCH_KEYS[1:]}
    assert _post(server, missing)[0] == 400


# ------------------------------------------- from a config and checkpoint --
CONF_THRESH = 0.4     # drops some of the boxes these weights keep


@pytest.fixture(scope="module")
def from_cfg(tmp_path_factory):
    """(port config, JAX scripts/serve.py Engine, checkpoint path, request):
    seed-3 weights of the smoke model, BN statistics randomized, saved as
    a reference-layout state_dict."""
    from scripts.serve import Engine as JEngine
    args = argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"),
        opts=["TPU.PLATFORM", "cpu", "MODEL.DECODER.CONF_THRESH",
              str(CONF_THRESH)])
    cfg, jcfg = get_cfg(), j_get_cfg()
    update_config(cfg, args)
    j_update_config(jcfg, args)
    model = build_model(ModelConfig.from_cfg(cfg), seed=3, device="cpu")
    randomize_frozen_bn(model, 4)
    path = str(tmp_path_factory.mktemp("serve") / "reference.pt")
    torch.save(model.state_dict(), path)
    batch = make_batch([11], image_size=tuple(cfg.TPU.IMAGE_SIZE))
    request = {k: batch[k] for k in BATCH_KEYS}
    return cfg, JEngine(jcfg, None, path, BATCH), path, request


def _assert_same_detections(got, want):
    assert len(want) > 0                          # not vacuous
    assert [d["label"] for d in got] == [d["label"] for d in want]
    for d, w in zip(got, want):
        for key in ("score", "center", "size", "corners_world"):
            np.testing.assert_allclose(d[key], w[key], atol=1e-4,
                                       err_msg=key)


def test_engine_from_cfg_and_checkpoint_matches_jax(from_cfg):
    cfg, jengine, path, request = from_cfg
    engine = Engine.from_cfg(cfg, checkpoint=path, batch_size=BATCH)
    assert engine.cfg.conf_thresh == CONF_THRESH
    assert engine.cfg.track_scale == tuple(
        float(v) for v in cfg.MODEL.DECODER.TRACK_SCALE)
    got = engine.detect(request)
    _assert_same_detections(got[0], jengine.detect(request)[0])
    assert all(d["score"] >= CONF_THRESH for d in got[0])
    engine.cfg = dataclasses.replace(engine.cfg, conf_thresh=0.0)
    assert len(engine.detect(request)[0]) > len(got[0])


def test_engine_from_artifact_matches_jax(from_cfg, tmp_path):
    """The artifact is exported with random weights from SEED; the
    engine loads the checkpoint's weights into it."""
    cfg, jengine, path, request = from_cfg
    blob, _, _ = export_forward(cfg, BATCH, device="cpu")
    artifact = str(tmp_path / "fwd.pt2")
    with open(artifact, "wb") as f:
        f.write(blob)
    engine = Engine.from_cfg(cfg, checkpoint=path, artifact=artifact,
                             batch_size=BATCH)
    assert engine.model.training is False
    _assert_same_detections(engine.detect(request)[0],
                            jengine.detect(request)[0])

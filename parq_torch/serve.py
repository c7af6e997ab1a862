"""HTTP serving of the port's eval forward (twin of scripts/serve.py).

    python -m parq_torch.serve --cfg configs/eval.yaml \
        [--CHECKPOINT_PATH ckpt] [--artifact parq_fwd.pt2] [--batch 8] \
        [--host 127.0.0.1] [--port 8000] [KEY VALUE ...]

The model is the one the config describes (`ServeConfig.from_cfg`: the
score threshold is MODEL.DECODER.CONF_THRESH, the track box TRACK_SCALE).
CHECKPOINT_PATH (the flag shadows the config key, as in eval.py) loads
strictly through `train.checkpoint.load_pretrained`: a port checkpoint or
a state_dict in the reference layout; without one the weights are random
from SEED and a warning says so. `--artifact` serves a program exported by
`python -m parq_torch.export` with the engine's weights loaded into it;
otherwise the live model serves. Both run the same custom ops for B1 and
B2. On the card the forward (of the model or of the artifact) is captured
once as a CUDA graph at the served batch size, by the engine's warm-up,
and each request replays it (parq_torch/graphs.py). It runs on CUDA and
raises without a GPU unless TPU.PLATFORM (or env PARQ_PLATFORM) is "cpu".

Protocol (input shapes are fixed by the served batch — GET /spec):

  GET  /healthz  -> {"status": "ok"}
  GET  /spec     -> {"batch_size": B, "inputs": {name: {shape, dtype}}}
  POST /detect   -> body: an .npz with rgb_img (B,T,H,W,3; float in [0,1]
                    or uint8), camera (B,T,6), T_camera_pseudoCam (B,T,12),
                    T_world_pseudoCam (B,T,12), T_world_local (B,1,12).
                    B may be <= the served batch size: requests are padded
                    to it and the padding is dropped from the response.
                    Response: {"detections": [[{label, score, center, size,
                    corners_world}, ...] per sample]}.

Requests serialize around the forward; the HTTP layer is threaded so
health checks never wait behind an inference.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .config import ServeConfig
from .data.synthetic import to_device
from .evals.parse_pred import parse_pred
from .export import example_batch, load_artifact, load_model
from .graphs import Graphed
from .models import BATCH_KEYS


class Engine:
    """Owns the model (or an exported program with the model's weights);
    turns request arrays into detections. `checkpoint` loads strictly into
    the model; `artifact` is a saved `torch.export` program
    (parq_torch.export), which then serves with the model's weights."""

    def __init__(self, cfg: ServeConfig = ServeConfig(), batch_size: int = 1,
                 device=None, seed: int = 0,
                 checkpoint: Optional[str] = None,
                 artifact: Optional[str] = None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # with an artifact the model only holds the weights: keep it on
        # the host
        self.model = load_model(cfg.model, seed, checkpoint,
                                "cpu" if artifact else self.device)
        call = self.model
        if artifact:
            call = load_artifact(artifact)
            call.load_state_dict(self.model.state_dict(), strict=True)
        # captured once at the served batch size (requests are padded to
        # it) and replayed per request: scripts/serve.py's jitted forward
        self._call = Graphed(call)
        self.example = example_batch(cfg.model, batch_size, self.device)
        self.spec = {k: {"shape": list(v.shape), "dtype": "float32"}
                     for k, v in self.example.items()}
        self.forward(self.example)      # warm-up (kernel build, cuDNN plans)
        logging.info("engine ready: batch=%d device=%s dtype=%s%s",
                     batch_size, self.device, cfg.model.compute_dtype,
                     f" artifact={artifact}" if artifact else "")

    @classmethod
    def from_cfg(cls, cfg, checkpoint: Optional[str] = None,
                 artifact: Optional[str] = None, batch_size: int = 1,
                 device=None) -> "Engine":
        """The engine of a config tree (scripts/serve.py's `Engine`): its
        model and host settings, weights from SEED or `checkpoint`, on
        the device TPU.PLATFORM names unless `device` is given."""
        from .config import platform_device
        return cls(ServeConfig.from_cfg(cfg), batch_size,
                   device or platform_device(cfg), int(cfg.SEED),
                   checkpoint, artifact)

    @torch.inference_mode()
    def forward(self, batch):
        """Tensor batch on the engine's device → per-iteration outputs."""
        out = self._call(batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _validate(self, arrays):
        missing = [k for k in BATCH_KEYS if k not in arrays]
        if missing:
            raise ValueError(f"missing arrays: {missing}")
        b = arrays["rgb_img"].shape[0] if arrays["rgb_img"].ndim else 0
        if not 1 <= b <= self.batch_size:
            raise ValueError(f"request batch {b} not in [1, "
                             f"{self.batch_size}] (see GET /spec)")
        out = {}
        for k in BATCH_KEYS:
            a = np.asarray(arrays[k])
            if k == "rgb_img" and a.dtype == np.uint8:
                a = a.astype(np.float32) / 255.0
            a = a.astype(np.float32)
            want = tuple(self.spec[k]["shape"])
            if a.shape[0] != b or a.shape[1:] != want[1:]:
                raise ValueError(f"{k}: got shape {tuple(a.shape)}, want "
                                 f"({b},) + {want[1:]}")
            if b < self.batch_size:     # pad to the served batch size
                a = np.concatenate(
                    [a, np.repeat(a[-1:], self.batch_size - b, axis=0)])
            out[k] = a
        return out, b

    def detect(self, arrays):
        """npz dict → per-sample detection lists (JSON-ready)."""
        host_batch, b = self._validate(arrays)
        batch = to_device(host_batch, BATCH_KEYS, self.device)
        with self._lock:
            outputs = self.forward(batch)
        last = {k: v[-1] for k, v in outputs.items()}
        cfg = self.cfg
        host = parse_pred(last, batch["T_world_local"], cfg.track_scale,
                          cfg.model.num_semcls, enable_nms=cfg.enable_nms)
        center = last["center_unnormalized"].float().cpu().numpy()
        size = last["size_unnormalized"].float().cpu().numpy()
        dets = []
        for i in range(b):
            keep = np.where(host["pred_mask"][i]
                            & (host["scores"][i] >= cfg.conf_thresh))[0]
            dets.append([{
                "label": int(host["labels"][i, k]),
                "score": float(host["scores"][i, k]),
                "center": center[i, k].tolist(),
                "size": size[i, k].tolist(),
                "corners_world": host["corners_world"][i, k].tolist(),
            } for k in keep])
        return dets


class Handler(BaseHTTPRequestHandler):
    def _send(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path == "/spec":
            self._send(200, {"batch_size": self.server.engine.batch_size,
                             "inputs": self.server.engine.spec})
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/detect":
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            try:
                arrays = dict(np.load(io.BytesIO(self.rfile.read(n)),
                                      allow_pickle=False))
            except Exception as e:  # malformed npz — the client's fault
                raise ValueError(f"bad npz body: {type(e).__name__}: {e}")
            dets = self.server.engine.detect(arrays)
        except ValueError as e:
            self._send(400, {"error": str(e)})
        except Exception as e:      # server-side failure: report, keep serving
            logging.exception("inference failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
        else:
            self._send(200, {"detections": dets})

    def log_message(self, fmt, *args):
        logging.info("%s %s", self.address_string(), fmt % args)


def build_server(engine: Engine, host: str = "127.0.0.1",
                 port: int = 0) -> ThreadingHTTPServer:
    """Bind a server for `engine` (port 0 = ephemeral)."""
    server = ThreadingHTTPServer((host, port), Handler)
    server.engine = engine
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(description="parq_torch serving runtime")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--artifact", default=None,
                    help=".pt2 from python -m parq_torch.export (default: "
                         "the live model)")
    ap.add_argument("--CHECKPOINT_PATH", type=str, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from .config import get_cfg, update_config
    cfg = get_cfg()
    update_config(cfg, args)
    if args.CHECKPOINT_PATH:    # the flag shadows the config key
        cfg.defrost()
        cfg.CHECKPOINT_PATH = args.CHECKPOINT_PATH
        cfg.freeze()
    ckpt = cfg.CHECKPOINT_PATH or None
    if not ckpt:
        logging.warning("no CHECKPOINT_PATH (flag or config): serving "
                        "RANDOM-INIT weights from SEED %d; detections carry "
                        "no meaning", int(cfg.SEED))
    server = build_server(Engine.from_cfg(cfg, ckpt, args.artifact,
                                          args.batch), args.host, args.port)
    print(f"serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]}  (POST /detect, GET /spec /healthz)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's parallel layer (parq_torch/parallel) on the CPU: ranks are
processes spawned over gloo (tests/torch_dist_workers.py), the JAX
package runs on the 8-device CPU mesh of tests/conftest.py with its Pallas
kernels in interpret mode.

(a) the four SP entries at 2 and 4 ranks against JAX's `sp_flash_*` at
    model 2 and 4, dropout 0.3 in 2 seed groups: outputs, lse and every
    gradient within 2e-5 (so each shard's seeds equal JAX's);
(b) the port's SP decoder in eval against JAX's SP decoder on the scene of
    tests/test_seq_parallel.py:208-245, within 2e-4;
(c) the tiny model's SP training gradients (2 ranks, dropout 0) against
    one process: loss rtol 1e-5, each gradient ‖Δ‖ ≤ 2e-4·max(‖g‖, 1) +
    1e-3 (tests/test_seq_parallel.py:267-273), and equal on both ranks;
(d) a 2-rank data-parallel train_step with dropout 0.1 against one
    process's step over the whole batch: metrics, clipped gradients and
    updated parameters to the same tolerance;
(e) checkpoints: rank 0 writes, every rank keeps the same index and can
    restore; the Trainer's grid clamps the data axis as the JAX Trainer;
(f) the train twin on configs/smoke.yaml as 2 ranks, data-parallel and
    sequence-parallel: rank 0 alone writes the metrics and the checkpoint,
    and the ranks end with the same parameters.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.models.decoder import PARQDecoder as JDecoder
from parq_tpu.parallel import (make_mesh as j_make_mesh,
                               sp_flash_cross_attention as j_sp,
                               sp_flash_cross_attention_fwd_lse as j_sp_lse,
                               sp_flash_cross_attention_kv_fused as j_sp_kv,
                               sp_flash_cross_attention_precomputed as j_sp_pre)

import torch_dist_workers as w
from parq_torch.config import ModelConfig, get_cfg, update_config
from parq_torch.data.synthetic import make_batch
from parq_torch.io.from_jax import decoder_state_dict_from_flax
from parq_torch.models import build_model
from parq_torch.parallel.seq_parallel import local_seed
from parq_torch.train.loop import make_trainer_mesh
from parq_torch.train.train_step import make_optimizer, train_step

import torch_common  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, Q, D = 2, 2, 16, 64
SEEDS = [1234577, 2 ** 31 - 5]


def test_local_seed_wraps_as_jax():
    """The shard seed, int32 with wrap-around, as JAX computes it."""
    from parq_tpu.parallel.seq_parallel import _SHARD_SEED_STRIDE
    for idx in range(4):
        want = (jnp.asarray(SEEDS, jnp.int32)
                + jnp.int32(idx) * jnp.int32(_SHARD_SEED_STRIDE))
        np.testing.assert_array_equal(local_seed(SEEDS, idx).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("world", [2, 4])
def test_sp_entries_match_jax(rng, tmp_path, world):
    """(a)"""
    n, rate = 64, 0.3
    inp = {"q": rng.randn(B, H, Q, D).astype(np.float32) * 0.5,
           "k": rng.randn(B, n, H * D).astype(np.float32) * 0.3,
           "v": rng.randn(B, n, H * D).astype(np.float32),
           "g": rng.randn(B, H, Q, D).astype(np.float32),
           "seeds": SEEDS, "rate": rate}
    inp["kv"] = np.stack([inp["k"].reshape(B, n, H, D),
                          inp["v"].reshape(B, n, H, D)],
                         axis=3).reshape(B, n, 2 * H * D)
    got = w.run_ranks(w.sp_entries, world, tmp_path, inp)

    mesh = j_make_mesh(data=8 // world, model=world)
    jq, jk, jv, jg = (jnp.asarray(inp[x]) for x in "qkvg")
    kw = dict(mesh=mesh, block_k=8, dropout_rate=rate,
              dropout_seed=jnp.asarray(SEEDS, jnp.int32), interpret=True)
    jo, jl = j_sp_lse(jq, jk, jv, **kw)
    want = {"fwd_lse": (np.asarray(jo), np.asarray(jl)[..., 0])}
    for name, fn in (
            ("train", lambda a, b, c: j_sp(a, b, c, **kw)),
            ("precomputed", lambda a, b, c: j_sp_pre(a, b, c, jo, jl, **kw))):
        y, vjp = jax.vjp(fn, jq, jk, jv)
        want[name] = (np.asarray(y),) + tuple(np.asarray(t)
                                              for t in vjp(jg))
    want["kv_fused"] = np.asarray(j_sp_kv(jq, jnp.asarray(inp["kv"]),
                                          mesh=mesh, block_k=8,
                                          interpret=True))
    for r, out in enumerate(got):
        rows = slice(r * n // world, (r + 1) * n // world)
        for a, b in zip(out["fwd_lse"], want["fwd_lse"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
        for name in ("train", "precomputed"):
            for i, what in enumerate(("o", "dq", "dk", "dv")):
                b = want[name][i]
                if what in ("dk", "dv"):
                    b = b[:, rows]
                np.testing.assert_allclose(out[name][i], b, rtol=0,
                                           atol=2e-5,
                                           err_msg=f"rank {r} {name} {what}")
        np.testing.assert_allclose(out["kv_fused"], want["kv_fused"], rtol=0,
                                   atol=2e-5)


# ---- (b) the decoder, on tests/test_seq_parallel.py's scene -------------
_B, _T, _Hm, _Wm, _C = 2, 2, 4, 8, 256
_L, _Q = 3, 8


def _scene(rng):
    from parq_tpu.geometry import Camera
    mem = rng.randn(_B, _T, _Hm, _Wm, _C).astype(np.float32)
    cam = np.broadcast_to(np.asarray(Camera.from_params(
        float(_Wm), float(_Hm), 4.0, 4.0, _Wm / 2, _Hm / 2).data),
        (_B, _T, 6)).astype(np.float32)
    eye = np.concatenate([np.eye(3).reshape(9), np.zeros(3)]).astype(
        np.float32)
    return {"mem": mem, "camera": cam,
            "Tcp": np.broadcast_to(eye, (_B, _T, 12)).copy(),
            "Twp": np.broadcast_to(eye, (_B, _T, 12)).copy(),
            "Twl": np.broadcast_to(eye, (_B, 1, 12)).copy()}


def test_sp_decoder_eval_matches_jax(rng, tmp_path):
    """(b)"""
    from parq_tpu.geometry import Camera, Pose
    scene = _scene(rng)
    jscene = (jnp.asarray(scene["mem"]), Camera(jnp.asarray(scene["camera"])),
              Pose(jnp.asarray(scene["Tcp"])), Pose(jnp.asarray(scene["Twp"])),
              Pose(jnp.asarray(scene["Twl"])))
    mesh = j_make_mesh(data=4, model=2)
    jdec = JDecoder(dim=_C, heads=2, ffn_dim=16, num_layers=_L,
                    dropout_rate=0.0, num_queries=_Q, num_semcls=3,
                    feat_size=(_Wm, _Hm), use_flash=True, force_kernels=True,
                    sp_mesh=mesh)
    params = jdec.init(jax.random.PRNGKey(0), *jscene, deterministic=True)
    want = jdec.apply(params, *jscene, deterministic=True)
    cfg = dict(dim=_C, heads=2, ffn_dim=16, num_layers=_L, num_queries=_Q,
               num_semcls=3, feat_size=(_Wm, _Hm), dropout_rate=0.0)
    state = decoder_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params["params"]))
    got = w.run_ranks(w.sp_decoder_eval, 2, tmp_path, cfg, state, scene)
    for out in got:
        assert sorted(out) == sorted(want)
        for k in want:
            np.testing.assert_allclose(out[k], np.asarray(want[k],
                                                          np.float32),
                                       rtol=0, atol=2e-4, err_msg=k)


# ---- (c), (d) the tiny model's training step ----------------------------
def _smoke_model_cfg(*opts):
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"), opts=list(opts)))
    return cfg, ModelConfig.from_cfg(cfg)


def _batch(n):
    mcfg = _smoke_model_cfg()[1]
    raw = make_batch(list(range(n)), image_size=mcfg.image_size)
    keys = ("rgb_img", "camera", "T_camera_pseudoCam", "T_world_pseudoCam",
            "T_world_local", "obbs_padded", "sym")
    return {k: np.asarray(raw[k], np.int32 if k == "sym" else np.float32)
            for k in keys if k in raw}


def _assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for n, g in want.items():
        nd = float((got[n] - g).norm())
        assert nd <= 2e-4 * max(float(g.norm()), 1.0) + 1e-3, \
            f"{n}: |Δ|={nd} vs |g|={float(g.norm())}"


def test_sp_training_gradients_match_single_process(tmp_path):
    """(c)"""
    _, mcfg = _smoke_model_cfg("MODEL.DECODER.TRANSFORMER.DROPOUT_RATE",
                               "0.0")
    batch = _batch(1)
    u = np.random.RandomState(0).rand(
        mcfg.dec_layers, mcfg.num_queries,
        batch["obbs_padded"].shape[1]).astype(np.float32)
    got = w.run_ranks(w.sp_model_grads, 2, tmp_path, mcfg, batch, u)
    model = build_model(mcfg, seed=1, device="cpu")
    losses, grads = w.model_grads(model, {k: torch.from_numpy(v)
                                          for k, v in batch.items()},
                                  torch.from_numpy(u))
    for r, (l_r, g_r) in enumerate(got):
        np.testing.assert_allclose(l_r["total_loss"], losses["total_loss"],
                                   rtol=1e-5)
        _assert_grads_close(g_r, grads)
        for n, g in g_r.items():          # every rank holds the same grads
            assert torch.equal(g, got[0][1][n]), (r, n)


def test_ddp_step_matches_single_process(tmp_path):
    """(d) dropout 0.1 on: the ranks draw the single process's masks."""
    _, mcfg = _smoke_model_cfg("MODEL.DECODER.TRANSFORMER.DROPOUT_RATE",
                               "0.1")
    batch = _batch(2)
    got = w.run_ranks(w.ddp_step, 2, tmp_path, mcfg, batch)
    model = build_model(mcfg, seed=1, device="cpu")
    opt = make_optimizer(model, lr=1e-3)
    m = train_step(model.train(), opt,
                   {k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(7))
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    params = {n: p.detach() for n, p in model.named_parameters()}
    for metrics, g_r, p_r in got:
        for k in ("total_loss", "grad_norm", "valid_bs"):
            np.testing.assert_allclose(metrics[k], float(m[k]), rtol=1e-5,
                                       err_msg=k)
        _assert_grads_close(g_r, grads)
        _assert_grads_close(p_r, params)


def test_checkpoints_rank0_writes(tmp_path):
    """(e)"""
    ckpt = tmp_path / "ckpt"
    got = w.run_ranks(w.checkpoint_barrier, 2, tmp_path, str(ckpt))
    for out in got:
        assert out["files"] == ["step_3.pt", "step_5.pt"]
        assert out["steps"] == [3, 5] and out["best"] == 3
        assert out["restored"]


@pytest.mark.parametrize("batch_size, want", [(8, 1), (9, 1)])
def test_trainer_mesh_single_process(batch_size, want):
    """(e) one process: a 1 x 1 grid whatever MESH_DATA says."""
    cfg = get_cfg()
    cfg.DATAMODULE.BATCH_SIZE = batch_size
    cfg.TPU.MESH_DATA = 4
    mesh = make_trainer_mesh(cfg)
    assert (mesh.data, mesh.model) == (want, 1)
    assert mesh.data_group is None and mesh.model_group is None


@pytest.mark.parametrize("opts, grid", [
    (("TPU.MESH_DATA", "2"), (2, 1)),
    (("TPU.SEQ_PARALLEL", "True", "TPU.MESH_MODEL", "2"), (1, 2))])
def test_train_twin_on_two_ranks(tmp_path, opts, grid):
    """(f)"""
    got = w.run_ranks(w.trainer_fit, 2, tmp_path,
                      os.path.join(ROOT, "configs", "smoke.yaml"),
                      str(tmp_path / "logs"), list(opts))
    for params, rows, ckpts, mesh in got:
        assert mesh == grid
        assert [r["step"] for r in rows if r["stage"] == "train"] == [1, 2]
        assert len([r for r in rows if r["stage"] == "val/metrics"]) == 1
        assert ckpts == ["index.json", "step_2.pt"]
        for n, p in params.items():
            assert torch.equal(p, got[0][0][n]), n

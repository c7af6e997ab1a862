"""The port's matcher, set loss and LR schedule against the JAX package on
the CPU, with the same inputs from numpy seeds and the JAX matcher's own
uniform draws fed to the port:

(e) `match_batch` against `match_single`, both branches (K ≤ Q: targets
    are the assignment's rows; K > Q: the transposed problem), with the
    proximity cap exercised: assignments and punish masks are equal;
(f) `set_loss` against JAX's on the same outputs and targets, atol 1e-5;
(g) `cosine_warmup_restarts` and `build_lr_schedule` at 50 epochs, cycle
    multipliers 1 and 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.config import get_cfg
from parq_tpu.geometry import Obb3D as JObb3D, Pose as JPose
from parq_tpu.losses import parse_targets as j_parse_targets
from parq_tpu.losses import set_loss as j_set_loss
from parq_tpu.ops.hungarian import match_single
from parq_tpu.train.schedule import build_lr_schedule as j_build_lr
from parq_tpu.train.schedule import cosine_warmup_restarts as j_cosine

from parq_torch.data.synthetic import make_batch
from parq_torch.geometry import Obb3D, Pose
from parq_torch.losses import parse_targets, set_loss
from parq_torch.ops.hungarian import match_batch
from parq_torch.train import build_lr_schedule, cosine_warmup_restarts

import torch_common  # noqa: F401


def jax_uniforms(key, n, Q, K):
    """The (n, Q, K) draws of JAX's match_batch for one key."""
    keys = jax.random.split(key, n)
    return np.array(jax.vmap(
        lambda k: jax.random.uniform(k, (Q, K)))(keys))


def _match_inputs(rng, LB, Q, K, n_valid, crowd):
    """Random logits and targets; `crowd` queries sit within 0.1 (L1) of
    target 0 of every pair, more than the cap of 10 when crowd > 10."""
    logits = rng.randn(LB, Q, 10).astype(np.float32)
    center = rng.uniform(-2, 2, (LB, K, 3)).astype(np.float32)
    coord = rng.uniform(-2, 2, (LB, Q, 3)).astype(np.float32)
    coord[:, :crowd] = center[:, :1] + rng.uniform(-0.03, 0.03,
                                                   (LB, crowd, 3))
    labels = rng.randint(0, 9, (LB, K)).astype(np.int32)
    valid = np.zeros((LB, K), bool)
    valid[:, :n_valid] = True
    valid[-1] = False                         # a pair with no target
    labels[~valid] = -1
    return logits, coord, labels, center, valid


@pytest.mark.parametrize("Q,K,n_valid,crowd", [
    (32, 12, 7, 14),      # K <= Q, the cap of 10 bites
    (8, 100, 5, 3),       # K > Q (the tiny config), fewer targets than Q
    (8, 100, 12, 3),      # K > Q, more valid targets than queries
])
def test_matcher_matches_jax(rng, Q, K, n_valid, crowd):
    LB = 4
    logits, coord, labels, center, valid = _match_inputs(rng, LB, Q, K,
                                                         n_valid, crowd)
    key = jax.random.PRNGKey(7)
    u = jax_uniforms(key, LB, Q, K)
    keys = jax.random.split(key, LB)
    got = match_batch(*(torch.from_numpy(a) for a in
                        (logits, coord, labels, center, valid)),
                      uniforms=torch.from_numpy(u))
    for i in range(LB):
        want = match_single(jnp.asarray(logits[i]), jnp.asarray(coord[i]),
                            jnp.asarray(labels[i]), jnp.asarray(center[i]),
                            jnp.asarray(valid[i]), keys[i])
        for name in ("assign", "is_hungarian", "punish_mask"):
            np.testing.assert_array_equal(
                getattr(got, name)[i].numpy(),
                np.asarray(getattr(want, name)), err_msg=f"{name}[{i}]")
    assert (got.assign[:LB - 1] >= 0).any()
    assert not got.assign[LB - 1].ge(0).any()     # no targets, no match
    if crowd > 10:                                # capped-out queries
        assert not got.punish_mask[:LB - 1].all()


def _loss_inputs(rng, L, B, Q, K):
    raw = make_batch(list(range(B)))
    obbs = raw["obbs_padded"][:, :K].astype(np.float32)
    twl = raw["T_world_local"].astype(np.float32)
    sym = raw["sym"].astype(np.int32)
    jt = j_parse_targets(JObb3D(jnp.asarray(obbs)), JPose(jnp.asarray(twl)),
                         jnp.asarray(sym))
    center = np.asarray(jt.center)
    coord = rng.uniform(-1.5, 1.5, (L, B, Q, 3)).astype(np.float32)
    coord[:, :, :4] = center[None, :, :1] + rng.uniform(-0.05, 0.05,
                                                       (L, B, 4, 3))
    outputs = {
        "pred_logits": rng.randn(L, B, Q, 10),
        "coord_pos": coord,
        "center_unnormalized": coord + rng.randn(L, B, Q, 3) * 0.2,
        "size_unnormalized": rng.uniform(0.2, 1.0, (L, B, Q, 3)),
        "ortho6d": rng.randn(L, B, Q, 6),
    }
    outputs = {k: np.asarray(v, np.float32) for k, v in outputs.items()}
    return outputs, obbs, twl, sym, jt


@pytest.mark.parametrize("K", [100, 10])
def test_set_loss_matches_jax(rng, K):
    """(f) every loss and valid_bs, atol 1e-5 (measured on this CPU: 6e-8
    on losses of 0.8-6.3), in both matcher branches; the targets too."""
    L, B, Q = 2, 2, 16
    outputs, obbs, twl, sym, jt = _loss_inputs(rng, L, B, Q, K)
    key = jax.random.PRNGKey(11)
    want = j_set_loss({k: jnp.asarray(v) for k, v in outputs.items()}, jt,
                      key)
    targets = parse_targets(Obb3D(torch.from_numpy(obbs)),
                            Pose(torch.from_numpy(twl)),
                            torch.from_numpy(sym))
    for name in ("labels", "center", "size", "rot", "valid", "sym",
                 "corners_world"):
        np.testing.assert_allclose(
            getattr(targets, name).numpy(), np.asarray(getattr(jt, name)),
            atol=1e-6, rtol=0, err_msg=name)
    got = set_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                   targets, uniforms=torch.from_numpy(
                       jax_uniforms(key, L * B, Q, K)))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert float(got["valid_bs"]) == L * B


@pytest.mark.parametrize("cycle_mult", [1.0, 2.0])
def test_cosine_schedule_matches_jax(cycle_mult):
    """(g) lr(epoch) over 50 epochs, rtol 2e-6: JAX computes in f32, the
    port in double (measured on this CPU: 9.1e-7 relative)."""
    first = 20 if cycle_mult == 1.0 else 8
    want_fn = j_cosine(first, 1e-3, 1e-5, 3, cycle_mult, gamma=0.9)
    got_fn = cosine_warmup_restarts(first, 1e-3, 1e-5, 3, cycle_mult,
                                    gamma=0.9)
    for e in range(50):
        np.testing.assert_allclose(got_fn(e), float(want_fn(e)), rtol=2e-6,
                                   err_msg=f"epoch {e}")


@pytest.mark.parametrize("cycle_mult", [1.0, 2.0])
def test_lr_derivation_matches_jax(cycle_mult):
    """(g) the reference's derivation: autoscale by the effective batch,
    min-lr, cycle split; lr(step) at 10 steps per epoch for 50 epochs,
    rtol 2e-6 (measured on this CPU: 5.2e-7 relative)."""
    cfg = get_cfg()
    cfg.DATAMODULE.BATCH_SIZE = 8
    cfg.TRAINER.GPUS = 2
    cfg.TRAINER.MAX_EPOCHS = 50
    cfg.OPTIMIZER.CYCLE_MULT = cycle_mult
    cfg.OPTIMIZER.NUM_RESTARTS = 3
    cfg.OPTIMIZER.WARMUP_EPOCHS = 2
    want = j_build_lr(cfg, steps_per_epoch=10)
    got = build_lr_schedule(base_lr=1e-4, batch_size=8, gpus=2,
                            max_epochs=50, steps_per_epoch=10,
                            warmup_epochs=2, cycle_mult=cycle_mult,
                            num_restarts=3)
    assert got.peak_lr == pytest.approx(want.peak_lr)
    for step in range(0, 500, 7):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-6,
                                   err_msg=f"step {step}")

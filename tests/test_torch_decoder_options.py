"""The decoder's options on the CPU against the JAX package: unshared
iterations (MODEL.DECODER.TRANSFORMER.SHARE_WEIGHTS False), the
per-iteration recompute (TPU.REMAT), the fold gate, checkpoints of an
unshared model, and TPU.DEBUG_NANS.

- A JAX PARQDecoder's init goes through `from_jax` into the port; the
  forward agrees to 2e-4 and every parameter's gradient (training mode,
  dropout 0) to ‖Δ‖ ≤ 1e-4·‖g‖ + 1e-7, the bound the port holds its fold
  to (tests/test_torch_train_model.py); both trees hold the same number of
  trainable scalars.
- The port's remat against its sequential path with dropout 0.1 from one
  generator: the recompute redraws the same masks, so the gradients are
  equal.
- With REMAT or unshared weights the two-phase fold never runs.
- A reference-layout state_dict warm-starts iteration 0 of an unshared
  model; a strict load of it fails listing iterations 1..L−1, as JAX's
  strict load with share_weights=False does; a port checkpoint of an
  unshared model round-trips strictly.
- A NaN-poisoned weight raises FloatingPointError in the forward of the
  model a Trainer sets up under DEBUG_NANS, naming the module, and in JAX
  under jax_debug_nans; a NaN made by a backward raises it too.
"""
import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parq_tpu.geometry import Camera as JCamera
from parq_tpu.geometry import Pose as JPose
from parq_tpu.models.decoder import PARQDecoder as JDecoder
from parq_tpu.train import load_pretrained as j_load_pretrained
from parq_tpu.train.train_step import TrainState

from parq_torch.config import ModelConfig, get_cfg, update_config
from parq_torch.data.synthetic import make_batch
from parq_torch.geometry import Camera, Pose
from parq_torch.io.from_jax import decoder_state_dict_from_flax
from parq_torch.models import BATCH_KEYS, build_model
from parq_torch.models.decoder import PARQDecoder
from parq_torch.train.checkpoint import load_pretrained
from parq_torch.train.loop import Trainer, to_device_batch

from torch_common import jax_init, jax_tiny_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, Hm, Wm, C = 2, 2, 4, 8, 32
HEADS, FFN, Q, SEMCLS = 4, 16, 8, 3
LOSS_KEYS = ("pred_logits", "center_unnormalized", "size_unnormalized",
             "ortho6d")


def scene(seed=0):
    rng = np.random.RandomState(seed)
    mem = rng.randn(B, T, Hm, Wm, C).astype(np.float32)
    cam = np.broadcast_to(np.asarray(JCamera.from_params(
        float(Wm), float(Hm), 4.0, 4.0, Wm / 2, Hm / 2).data),
        (B, T, 6)).astype(np.float32)
    eye = np.concatenate([np.eye(3).reshape(9), np.zeros(3)]).astype(
        np.float32)
    poses = [np.broadcast_to(eye, (B, n, 12)).copy() for n in (T, T, 1)]
    return [mem, cam] + poses


def jax_decoder(L, share_weights=True, remat=False):
    return JDecoder(dim=C, heads=HEADS, ffn_dim=FFN, num_layers=L,
                    dropout_rate=0.0, num_queries=Q, num_semcls=SEMCLS,
                    feat_size=(Wm, Hm), share_weights=share_weights,
                    remat=remat)


def port_decoder(L, **kw):
    kw = dict(dict(dropout_rate=0.0), **kw)
    return PARQDecoder(dim=C, heads=HEADS, ffn_dim=FFN, num_layers=L,
                       num_queries=Q, num_semcls=SEMCLS,
                       feat_size=(Wm, Hm), **kw)


def jax_args(arrs):
    mem, cam, tcp, twp, twl = (jnp.asarray(a) for a in arrs)
    return mem, JCamera(cam), JPose(tcp), JPose(twp), JPose(twl)


def port_args(arrs, requires_grad=False):
    mem, cam, tcp, twp, twl = (torch.from_numpy(a.copy()) for a in arrs)
    mem.requires_grad_(requires_grad)
    return mem, Camera(cam), Pose(tcp), Pose(twp), Pose(twl)


def loss_of(out):
    return sum((out[k].astype(jnp.float32) ** 2).mean()
               if isinstance(out[k], jnp.ndarray)
               else out[k].float().square().mean() for k in LOSS_KEYS)


@functools.partial(jax.jit, static_argnums=0)
def jax_init_decoder(jdec, *args):
    return jdec.init(jax.random.PRNGKey(0), *args, deterministic=True)


@functools.partial(jax.jit, static_argnums=0)
def jax_grads(jdec, params, *args):
    return jax.grad(lambda p: loss_of(jdec.apply(
        {"params": p}, *args, deterministic=False)))(params)


def port_grads(dec, arrs, generator=None):
    dec.zero_grad(set_to_none=True)
    out = dec(*port_args(arrs), deterministic=False, generator=generator)
    loss_of(out).backward()
    return {n: p.grad.clone() for n, p in dec.named_parameters()}


def assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for n, g in want.items():
        err = float((got[n] - g).norm())
        assert err <= 1e-4 * float(g.norm()) + 1e-7, (n, err,
                                                      float(g.norm()))


@pytest.mark.parametrize("share_weights, remat", [
    (False, False), (True, True), (False, True)])
def test_options_match_jax(share_weights, remat):
    """Forward 2e-4 (eval), gradients by norm (training, dropout 0), and
    equal trainable-scalar counts."""
    L = 3
    arrs = scene()
    jdec = jax_decoder(L, share_weights, remat)
    params = jax_init_decoder(jdec, *jax_args(arrs))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert (("iteration" in params) == share_weights
            and ("iteration_2" in params) != share_weights)
    dec = port_decoder(L, share_weights=share_weights, remat=remat)
    dec.load_state_dict(decoder_state_dict_from_flax(params), strict=True)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in dec.parameters()) == n_jax

    want = jdec.apply({"params": params}, *jax_args(arrs),
                      deterministic=True)
    with torch.no_grad():
        got = dec(*port_args(arrs))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   atol=2e-4, rtol=2e-4, err_msg=k)

    jg = jax_grads(jdec, params, *jax_args(arrs))
    want_g = decoder_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jg))
    assert_grads_close(port_grads(dec.train(), arrs), want_g)


def test_remat_redraws_the_same_dropout():
    """Dropout 0.1, one generator seed: remat's gradients equal the
    sequential path's (‖Δ‖ ≤ 1e-6·‖g‖ + 1e-9; the recompute runs the
    same operations on the same values), and the dropout ran."""
    L = 3
    arrs = scene(1)
    grads, outs = {}, {}
    for remat in (False, True):
        torch.manual_seed(0)
        dec = port_decoder(L, dropout_rate=0.1, remat=remat,
                           batched_grad=False)
        with torch.no_grad():
            for p in dec.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                    .manual_seed(p.numel())) * 0.3)
        grads[remat] = port_grads(dec.train(), arrs,
                                  torch.Generator().manual_seed(7))
        with torch.no_grad():
            outs[remat] = dec(*port_args(arrs), deterministic=False,
                              generator=torch.Generator().manual_seed(7))
    for n, g in grads[False].items():
        err = float((grads[True][n] - g).norm())
        assert err <= 1e-6 * float(g.norm()) + 1e-9, (n, err)
    with torch.no_grad():
        plain = dec(*port_args(arrs), deterministic=True)
    assert not torch.allclose(plain["pred_logits"],
                              outs[True]["pred_logits"], atol=1e-3)


@pytest.mark.parametrize("share_weights, remat, folds", [
    (True, False, True), (True, True, False), (False, False, False)])
def test_fold_gate(share_weights, remat, folds, monkeypatch):
    """The folded call (`precomputed`) and its trajectory pass
    (`refs_only`) run only with shared weights and no remat."""
    dec = port_decoder(3, share_weights=share_weights, remat=remat,
                       dropout_rate=0.1)
    calls = []
    inner = PARQDecoder._iteration

    def spy(self, *a, **kw):
        calls.append(bool(kw.get("refs_only") or
                          kw.get("precomputed") is not None))
        return inner(self, *a, **kw)
    monkeypatch.setattr(PARQDecoder, "_iteration", spy)
    out = dec.train()(*port_args(scene(), requires_grad=True),
                      deterministic=False,
                      generator=torch.Generator().manual_seed(0))
    loss_of(out).backward()
    assert dec.folds(False) == folds
    assert any(calls) == folds
    if not folds:     # one call per iteration, plus each recompute
        assert len(calls) == 3 * (2 if remat else 1)


# ---------------------------------------------------------- checkpoints --
def _tiny(**kw):
    return ModelConfig.tiny(dec_layers=3, **kw)


def test_unshared_checkpoint_loads(tmp_path):
    """A reference-layout state_dict (a shared model's) warm-starts
    iteration 0 of an unshared model; a strict load fails listing
    iterations 1 and 2, and so does JAX's with share_weights=False; a port
    checkpoint of the unshared model round-trips strictly."""
    ref = build_model(_tiny(), seed=1, device="cpu")
    path = str(tmp_path / "reference.pt")
    torch.save(ref.state_dict(), path)
    model = build_model(_tiny(share_weights=False), seed=2, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError) as e:
        load_pretrained(model, path, strict=True)
    msg = str(e.value)
    for i in (1, 2):
        assert f"missing in checkpoint: box3d_decoder.iterations.{i}." in msg
    assert "unexpected" not in msg
    load_pretrained(model, path, strict=False)
    own = ref.state_dict()
    for k, v in model.state_dict().items():
        want = own[k] if k in own else before[k]
        assert torch.equal(v, want), k
    assert any(k.startswith("box3d_decoder.iterations.2.") for k in before)

    out = str(tmp_path / "unshared.pt")
    torch.save({"model": model.state_dict()}, out)
    again = build_model(_tiny(share_weights=False), seed=3, device="cpu")
    load_pretrained(again, out, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k

    # JAX: the same file into an unshared JAX model
    cfg = _tiny()
    jmodel = jax_tiny_model(cfg).clone(dec_layers=3, share_weights=False)
    raw = make_batch([0], image_size=cfg.image_size)
    variables = jax_init(jmodel, jax.random.PRNGKey(0),
                         {k: jnp.asarray(raw[k]) for k in BATCH_KEYS})
    state = TrainState(step=0, params=variables["params"],
                       frozen=variables["frozen"], opt_state=None,
                       tx=optax.identity(), apply_fn=jmodel.apply)
    with pytest.raises(ValueError) as e:
        j_load_pretrained(state, path, num_heads=4, share_weights=False,
                          strict=True)
    jmsg = str(e.value)
    for i in (1, 2):
        assert f"missing in checkpoint: params/box3d_decoder/iteration_{i}/" \
            in jmsg
    j_load_pretrained(state, path, num_heads=4, share_weights=False)


# ----------------------------------------------------------- DEBUG_NANS --
def test_debug_nans_raises_in_port_and_jax(tmp_path):
    """A NaN in the first decoder layer's FFN weight: the forward of the
    model a Trainer sets up under TPU.DEBUG_NANS and JAX's forward under
    jax_debug_nans both raise FloatingPointError; the port names the
    module."""
    args = argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"),
        opts=["TPU.PLATFORM", "cpu", "TPU.DEBUG_NANS", "True",
              "LOG_PATH", str(tmp_path)])
    cfg = get_cfg()
    update_config(cfg, args)
    trainer = Trainer(cfg)
    trainer.setup_state(steps_per_epoch=1)
    try:
        layer = trainer.model.box3d_decoder.parq_module.decoder.layers[0]
        with torch.no_grad():
            layer.linear1.weight[0, 0] = float("nan")
        batch = make_batch([0, 1], image_size=trainer.model_cfg.image_size)
        with pytest.raises(FloatingPointError, match="linear1"):
            trainer.model(to_device_batch(batch, "cpu"))
    finally:
        torch.autograd.set_detect_anomaly(False)

    arrs = scene()
    jdec = jax_decoder(2)
    params = jdec.init(jax.random.PRNGKey(0), *jax_args(arrs),
                       deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    params["iteration"]["layer"]["linear1"]["kernel"][0, 0] = np.nan
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jax.jit(lambda p, *a: jdec.apply({"params": p}, *a,
                                             deterministic=True))(
                params, *jax_args(arrs))
    finally:
        jax.config.update("jax_debug_nans", False)


def test_debug_nans_backward_raises():
    """The backward half: a NaN that only the backward makes (the gradient
    of sqrt at 0 times 0) raises FloatingPointError under `nan_errors`."""
    from parq_torch.train import debug_nans
    lin = torch.nn.Linear(2, 2)
    handles = debug_nans.enable(lin)
    try:
        x = torch.zeros(1, 2, requires_grad=True)
        y = lin(x).sum() + (torch.sqrt(x) * 0.0).sum()
        with pytest.raises(FloatingPointError, match="nan values"):
            with debug_nans.nan_errors():
                y.backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
        for h in handles:
            h.remove()

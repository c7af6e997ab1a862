"""The port's training step against the JAX package and against itself, on
the CPU at the tiny flagship width (resnet18, 64x48, L=2, Q=8, dim 32):

(h) the batched-gradient fold against the port's sequential training path,
    with dropout live: outputs, and every parameter's gradient by norm
    (the port's twin of tests/test_batched_grad.py);
(i) the whole slice: the same weights, batch and matcher draws through
    JAX's `train_step` pieces and the port's `train_step`, f32, dropout 0
    (JAX's `bernoulli` bits cannot be drawn in torch; the flash dropout is
    exact and covered in test_torch_train_kernels.py): the loss, every
    parameter's gradient, and the parameters after one AdamW step;
and the decoder's LayerNorm epsilon, on rows whose variance is ~1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parq_tpu.io.torch_convert import convert_parq_checkpoint
from parq_tpu.models.decoder import DecoderLayer as JDecoderLayer
from parq_tpu.train import LossConfig as JLossConfig
from parq_tpu.train import forward_and_loss as j_forward_and_loss
from parq_tpu.train import make_optimizer as j_make_optimizer
from parq_tpu.train.checkpoint import _merge

from parq_torch.config import ModelConfig
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.io.from_jax import grads_from_flax, state_dict_from_flax
from parq_torch.kernels.cross_attention import split_kv
from parq_torch.models import BATCH_KEYS, build_model
from parq_torch.train import eval_step, make_optimizer, train_step
from parq_torch.train.__main__ import TRAIN_KEYS, main as train_main
from test_torch_model import (jax_tiny_model, numpy_state_dict,
                              randomize_frozen_bn)


def _grads_of(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_fold_matches_sequential_path(rate):
    """(h) outputs atol 1e-5 and gradients ‖Δ‖ ≤ 1e-4·‖g‖ + 1e-7 per
    parameter (measured on this CPU at rate 0.4: outputs 7e-7, gradients
    8e-7 relative): the fold draws each iteration's dropout as the
    sequential path does."""
    cfg = ModelConfig.tiny(dropout_rate=rate)
    batch = to_device(make_batch([0, 1], image_size=cfg.image_size),
                      BATCH_KEYS, "cpu")
    runs = {}
    for batched in (True, False):
        model = build_model(dataclasses.replace(cfg, batched_grad=batched),
                            seed=0, device="cpu").train()
        out = model(batch, deterministic=False,
                    generator=torch.Generator().manual_seed(7))
        loss = sum(v.float().square().mean() for v in out.values()
                   if v.requires_grad)
        loss.backward()
        runs[batched] = (out, _grads_of(model))
    (o_fold, g_fold), (o_seq, g_seq) = runs[True], runs[False]
    assert sorted(o_fold) == sorted(o_seq)
    for k in o_seq:
        assert o_fold[k].shape == o_seq[k].shape, k
        np.testing.assert_allclose(o_fold[k].float().detach().numpy(),
                                   o_seq[k].float().detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    for n, g in g_seq.items():
        err = float((g_fold[n] - g).norm())
        assert err <= 1e-4 * float(g.norm()) + 1e-7, (n, err)
    if rate > 0:     # the dropout really ran: outputs differ from rate 0
        model = build_model(ModelConfig.tiny(dropout_rate=0.0), seed=0,
                            device="cpu")
        plain = model(batch, deterministic=False)
        assert not torch.allclose(plain["pred_logits"],
                                  o_seq["pred_logits"], atol=1e-3)


def test_eval_step_is_deterministic_and_free_of_gradients():
    """eval_step: the deterministic forward and the loss, with no
    gradient, equal across calls."""
    cfg = ModelConfig.tiny()
    model = build_model(cfg, seed=0, device="cpu")
    batch = to_device(make_batch([0, 1], image_size=cfg.image_size),
                      TRAIN_KEYS, "cpu")
    u = torch.rand(cfg.dec_layers * 2, cfg.num_queries, 100,
                   generator=torch.Generator().manual_seed(0))
    (l1, o1), (l2, _) = (eval_step(model, batch, uniforms=u)
                         for _ in range(2))
    assert not l1["total_loss"].requires_grad
    assert torch.isfinite(l1["total_loss"]) and float(l1["valid_bs"]) > 0
    assert all(torch.equal(l1[k], l2[k]) for k in l1)
    assert o1["pred_logits"].shape == (cfg.dec_layers, 2, cfg.num_queries,
                                       cfg.num_semcls + 1)


def test_trainer_entry_point(capsys):
    """`python -m parq_torch.train --device cpu` trains the tiny model; with
    no device named and no GPU it raises."""
    train_main(["--steps", "2", "--batch", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("train: tiny B=2")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["step 0", "step 1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--steps", "1"])


def _jax_and_port(lr):
    cfg = ModelConfig.tiny(dropout_rate=0.0)
    port = build_model(cfg, seed=2, device="cpu").train()
    randomize_frozen_bn(port, 3)
    jmodel = jax_tiny_model(cfg).clone(dropout_rate=0.0)
    raw = make_batch([0, 1], image_size=cfg.image_size)
    jbatch = {k: jnp.asarray(raw[k]) for k in TRAIN_KEYS}
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    tree = convert_parq_checkpoint(numpy_state_dict(port), num_heads=4)
    params = _merge(init["params"], tree["params"])
    frozen = _merge(init["frozen"], tree["frozen"])
    return port, jmodel, params, frozen, raw, jbatch


def test_train_step_matches_jax():
    """(i) loss atol 2e-4 (measured on this CPU: 2e-6); each parameter's
    clipped gradient ‖Δ‖ ≤ 1e-3·‖g‖ + 1e-5 (measured: 1.3e-5 relative at
    worst). The parameters after one AdamW step: Adam's first step is
    lr·g/(|g| + eps), ill-posed wherever a gradient entry is below eps or
    within its own error (the K projection's bias has an exact gradient of
    0: softmax ignores a per-row constant). So the step is held where it is
    well posed — entries with |g| > max(2·|Δg|, 1e-6) agree to 1e-3·lr —
    and the port's AdamW, fed JAX's gradients, matches optax everywhere to
    1e-3·lr; both beside rtol 1e-6 for the f32 rounding of the parameter
    itself."""
    lr = 1e-4
    port, jmodel, params, frozen, raw, jbatch = _jax_and_port(lr)
    key = jax.random.PRNGKey(3)
    loss_cfg = JLossConfig()

    def loss_fn(p):
        losses, _ = j_forward_and_loss(jmodel.apply, p, frozen, jbatch, key,
                                       loss_cfg, deterministic=False)
        return losses["total_loss"], losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn,
                                                      has_aux=True))(params)
    tx = j_make_optimizer(lambda s: lr, grad_clip=1.0)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)
    jnorm = float(optax.global_norm(jgrads))

    # the matcher's draws, as JAX's forward_and_loss derives them
    _, k_match = jax.random.split(key)
    L, B, Q, K = 2, 2, 8, raw["obbs_padded"].shape[1]
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (Q, K)))(
        jax.random.split(k_match, L * B)))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    metrics = train_step(port, make_optimizer(port, lr=lr),
                         to_device(raw, TRAIN_KEYS, "cpu"), None,
                         uniforms=torch.from_numpy(u))

    for name in jlosses:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jlosses[name]), atol=2e-4, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jnorm,
                               rtol=1e-4)
    scale = min(1.0, 1.0 / jnorm)
    want_g = {n: g * scale for n, g in grads_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    want_p = state_dict_from_flax({"params": jax.tree_util.tree_map(
        np.asarray, jnew), "frozen": frozen})
    assert sorted(want_g) == sorted(n for n, _ in port.named_parameters())
    for n, p in port.named_parameters():
        g_ref = want_g[n]
        err = float((p.grad - g_ref).norm())
        assert err <= 1e-3 * float(g_ref.norm()) + 1e-5, (n, err)
        posed = g_ref.abs() > torch.clamp(2 * (p.grad - g_ref).abs(),
                                          min=1e-6)
        excess = ((p.detach() - want_p[n]).abs()
                  - 1e-6 * want_p[n].abs())[posed]
        assert excess.numel() == 0 or float(excess.max()) <= 1e-3 * lr, n

    # the optimizer alone: the port's AdamW on JAX's clipped gradients
    with torch.no_grad():
        for n, p in port.named_parameters():
            p.copy_(before[n])
            p.grad = want_g[n].clone()
    make_optimizer(port, lr=lr).step()
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   atol=1e-3 * lr, rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("eps,agrees", [(1e-6, True), (1e-5, False)])
def test_layernorm_eps_matches_jax(rng, eps, agrees):
    """The decoder's LayerNorms use flax's eps 1e-6, as the JAX package
    does. Rows of variance ~1e-5 into norm1 (the self-attention's output
    projection zeroed) show it: at 1e-6 the layer agrees with JAX to 1e-4
    (measured on this CPU: 6.0e-7); at the torch reference's 1e-5 it is
    off by far more (measured: 0.52)."""
    cfg = ModelConfig.tiny()
    port = build_model(cfg, seed=4, device="cpu")
    layer = port.box3d_decoder.parq_module.decoder.layers[0]
    with torch.no_grad():
        layer.self_attn.out_proj.weight.zero_()
        layer.self_attn.out_proj.bias.zero_()
    tree = convert_parq_checkpoint(numpy_state_dict(port), num_heads=4)
    lp = tree["params"]["box3d_decoder"]["iteration"]["layer"]
    B, Q, N, C = 2, 8, 20, cfg.dec_dim
    tgt = (rng.randn(B, Q, C) * 3e-3).astype(np.float32)
    qpos = rng.randn(B, Q, C).astype(np.float32)
    mem = rng.randn(B, N, C).astype(np.float32)
    with torch.no_grad():
        kv = torch.nn.functional.linear(torch.from_numpy(mem),
                                        *layer.fused_kv_projection())
    k, v = (t.contiguous().numpy() for t in split_kv(kv, 4))
    jlayer = JDecoderLayer(C, 4, cfg.dec_ffn_dim, 0.0, True)
    want = jlayer.apply({"params": lp}, jnp.asarray(tgt), jnp.asarray(k),
                        jnp.asarray(v), jnp.asarray(qpos))
    for norm in (layer.norm1, layer.norm2, layer.norm3):
        norm.eps = eps
    with torch.no_grad():
        got = layer(torch.from_numpy(tgt), kv, torch.from_numpy(qpos))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert (err <= 1e-4) == agrees, err

"""The training kernels' plain versions against the JAX package, f32, on
the CPU (the Pallas kernels in interpret mode):

(a) the dropout keep mask, bit for bit, read off the JAX kernel's output;
(b) B2's train form (o, lse) against `flash_cross_attention_kv_fused_fwd_lse`;
(c) B3 through the port's autograd entries against `jax.vjp` of
    `flash_cross_attention_kv_fused_train`, dropout 0.3 in 2 seed groups;
(d) B4 against `_pallas_sample_bwd_mem`, and the sampler's whole backward
    (d memory, d uvs on the first `diff_rows` rows) against
    `_sample_fast_bwd`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.kernels.cross_attention_pallas import (
    flash_cross_attention_kv_fused_fwd_lse as j_fwd_lse,
    flash_cross_attention_kv_fused_train as j_train)
from parq_tpu.kernels.pixel_align_pallas import (_pallas_sample_bwd_mem,
                                                 _sample_fast_bwd)

from parq_torch.kernels import flash_fwd_lse, sample_views_bwd_mem
from parq_torch.kernels.cross_attention import (
    cross_attention_kv_fused_train_plain,
    flash_cross_attention_kv_fused_fwd_lse,
    flash_cross_attention_kv_fused_precomputed,
    flash_cross_attention_kv_fused_train, keep_mask)
from parq_torch.kernels.pixel_align import _sampler_backward


def _unit_v_inputs(rng, B, H, Q, N, D):
    """Logits near 0 and V rows e_n (N ≤ D): o[.., q, n] is
    keep(q, n)·p/(1 − rate) with p ≈ 1/N, so o ≠ 0 exactly where kept."""
    q = (rng.randn(B, H, Q, D) * 0.01).astype(np.float32)
    kv = np.zeros((B, N, H, 2, D), np.float32)
    kv[:, :, :, 0] = rng.randn(B, N, H, D) * 0.01
    kv[:, np.arange(N), :, 1, np.arange(N)] = 1.0
    return q, kv.reshape(B, N, 2 * H * D)


@pytest.mark.parametrize("G", [1, 4])
def test_keep_mask_is_the_jax_kernels_bits(rng, G):
    """(a) exact: the JAX kernel's kept weights against `keep_mask`."""
    B, H, Q, N, D, rate = 2, 2, 16, 48, 64, 0.3
    q, kv = _unit_v_inputs(rng, B, H, Q, N, D)
    seeds = [123457 + 977 * g for g in range(G)]
    o, _ = j_fwd_lse(jnp.asarray(q), jnp.asarray(kv), dropout_rate=rate,
                     dropout_seed=jnp.asarray(seeds, jnp.int32), block_k=16,
                     interpret=True)
    jax_keep = np.asarray(o)[..., :N] != 0.0                 # (B, H, Q, N)
    bh = torch.arange(B * H).view(B, H, 1)
    port = keep_mask(torch.tensor(seeds).view(1, 1, G), bh, Q // G, N, rate)
    port = port.reshape(B, H, Q, N).numpy()
    np.testing.assert_array_equal(port, jax_keep)
    assert 0.6 < port.mean() < 0.8          # measured: the rate is honoured


def test_folded_call_equals_separate_calls(rng):
    """(a) the port: one call over G seed groups gives (o, lse) equal to
    G calls of one group each; and so does the JAX kernel."""
    B, H, Q0, G, N, D, rate = 2, 2, 8, 4, 40, 64, 0.3
    q = rng.randn(B, H, G * Q0, D).astype(np.float32)
    kv = rng.randn(B, N, 2 * H * D).astype(np.float32)
    seeds = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    o, lse = flash_fwd_lse(torch.from_numpy(q), torch.from_numpy(kv), seeds,
                           rate)
    jo, _ = j_fwd_lse(jnp.asarray(q), jnp.asarray(kv), dropout_rate=rate,
                      dropout_seed=jnp.asarray(seeds.numpy()), block_k=16,
                      interpret=True)
    for g in range(G):
        rows = slice(g * Q0, (g + 1) * Q0)
        og, lg = flash_fwd_lse(torch.from_numpy(q[:, :, rows]),
                               torch.from_numpy(kv), seeds[g:g + 1], rate)
        assert torch.equal(o[:, :, rows], og)
        assert torch.equal(lse[:, :, rows], lg)
        jg, _ = j_fwd_lse(jnp.asarray(q[:, :, rows]), jnp.asarray(kv),
                          dropout_rate=rate, dropout_seed=int(seeds[g]),
                          block_k=16, interpret=True)
        np.testing.assert_array_equal(np.asarray(jo)[:, :, rows],
                                      np.asarray(jg))


def test_train_forward_matches_jax(rng):
    """(b) o and lse, f32, atol 1e-5 (measured on this CPU: o 1.2e-7,
    lse 4.8e-7)."""
    B, H, Q, N, D, rate = 2, 2, 16, 100, 64, 0.3
    q = rng.randn(B, H, Q, D).astype(np.float32)
    kv = (rng.randn(B, N, 2 * H * D) * 0.5).astype(np.float32)
    seeds = [31, 97]
    jo, jl = j_fwd_lse(jnp.asarray(q), jnp.asarray(kv), dropout_rate=rate,
                       dropout_seed=jnp.asarray(seeds, jnp.int32),
                       block_k=32, interpret=True)
    o, lse = cross_attention_kv_fused_train_plain(
        torch.from_numpy(q), torch.from_numpy(kv),
        torch.tensor(seeds, dtype=torch.int32), rate)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0],
                               atol=1e-5, rtol=0)
    o2, lse2 = flash_cross_attention_kv_fused_fwd_lse(
        torch.from_numpy(q), torch.from_numpy(kv), dropout_rate=rate,
        dropout_seed=seeds)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_backward_matches_jax_vjp(rng):
    """(c) dq and dKV, f32, atol 1e-4 (measured on this CPU: dq 8.2e-8,
    dKV 1.6e-7), through both the differentiable entry and the
    precomputed one."""
    B, H, Q, N, D, rate = 2, 2, 16, 100, 64, 0.3
    q = rng.randn(B, H, Q, D).astype(np.float32)
    kv = (rng.randn(B, N, 2 * H * D) * 0.5).astype(np.float32)
    do = rng.randn(B, H, Q, D).astype(np.float32)
    seeds = [31, 97]
    f = lambda a, b: j_train(a, b, dropout_rate=rate,
                             dropout_seed=jnp.asarray(seeds, jnp.int32),
                             block_k=32, interpret=True)
    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(kv))
    jdq, jdkv = vjp(jnp.asarray(do))
    tq = torch.from_numpy(q).requires_grad_(True)
    tkv = torch.from_numpy(kv).requires_grad_(True)
    o = flash_cross_attention_kv_fused_train(tq, tkv, dropout_rate=rate,
                                             dropout_seed=seeds)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=1e-5, rtol=0)
    o_pre, lse = flash_cross_attention_kv_fused_fwd_lse(
        tq, tkv, dropout_rate=rate, dropout_seed=seeds)
    o2 = flash_cross_attention_kv_fused_precomputed(
        tq, tkv, o_pre, lse, dropout_rate=rate, dropout_seed=seeds)
    for out in (o, o2):
        dq, dkv = torch.autograd.grad(out, (tq, tkv), torch.from_numpy(do))
        np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(dkv.numpy(), np.asarray(jdkv), atol=1e-4,
                                   rtol=0)


def test_entries_check_seeds_as_jax_does():
    q = torch.zeros(1, 2, 8, 64)
    kv = torch.zeros(1, 4, 256)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        flash_cross_attention_kv_fused_train(q, kv, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not divisible"):
        flash_cross_attention_kv_fused_train(q, kv, dropout_rate=0.1,
                                             dropout_seed=[1, 2, 3])
    with pytest.raises(ValueError, match="replicates"):
        flash_cross_attention_kv_fused_train(q, kv, dropout_rate=0.1,
                                             dropout_seed=1, q_tile=4)


def _sampler_inputs(rng, B=2, T=3, H=6, W=8, C=16, Q=12):
    uv = rng.rand(B, T, Q, 2) * [W + 4.0, H + 4.0] - 2.0
    uv[0, :, 0] = [1e6, -3e5]      # far off the image (behind the camera)
    scale = np.broadcast_to(rng.rand(B, 1, Q, 1), (B, T, Q, 1))
    uvs = np.concatenate([uv, scale, np.zeros((B, T, Q, 1))], -1)
    mem = rng.randn(B, T, H, W, C)
    g = rng.randn(B, Q, C)
    return (uvs.astype(np.float32), g.astype(np.float32),
            mem.astype(np.float32))


def test_sampler_bwd_mem_matches_jax(rng):
    """(d) B4's plain version against the Pallas kernel, f32, atol 1e-5
    (measured on this CPU: 2.4e-7; both sum in f32 here)."""
    uvs, g, mem = _sampler_inputs(rng)
    want = _pallas_sample_bwd_mem(jnp.asarray(uvs), jnp.asarray(g),
                                  mem.shape, jnp.float32)
    got = sample_views_bwd_mem(torch.from_numpy(uvs), torch.from_numpy(g),
                               mem.shape, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("diff_rows", [None, 5])
def test_sampler_backward_matches_jax(rng, diff_rows):
    """(d) d(memory) and d(uvs) of the training sampler against the JAX
    custom VJP's backward, f32, atol 1e-5 and 1e-4 (measured on this CPU:
    2.4e-7 and 2.4e-6; d(uvs) carries pixel-scale weights)."""
    uvs, g, mem = _sampler_inputs(rng)
    jdm, jdu = _sample_fast_bwd(diff_rows, (jnp.asarray(mem),
                                            jnp.asarray(uvs)),
                                jnp.asarray(g))
    dm, du = _sampler_backward(torch.from_numpy(mem), torch.from_numpy(uvs),
                               torch.from_numpy(g), diff_rows)
    np.testing.assert_allclose(dm.numpy(), np.asarray(jdm), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), atol=1e-4,
                               rtol=0)

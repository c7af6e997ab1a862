"""The training kernels' plain versions against the JAX package, f32, on
the CPU (the Pallas kernels in interpret mode):

(a) the dropout keep mask, bit for bit, read off the JAX kernel's output;
(b) B2's train form (o, lse) against `flash_cross_attention_kv_fused_fwd_lse`;
(c) B3 through the port's autograd entries against `jax.vjp` of
    `flash_cross_attention_kv_fused_train`, dropout 0.3 in 2 seed groups;
(d) B4 against `_pallas_sample_bwd_mem`, also on the inputs that are
    delicate for a per-pixel gather (one pixel, image and tile borders, all
    off the image, Q = 1) and on random small shapes, and the sampler's
    whole backward (d memory, d uvs on the first `diff_rows` rows) against
    `_sample_fast_bwd`.
"""
import hypothesis
import hypothesis.strategies as st
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
    cross_attention_kv_fused_split_plain,
    cross_attention_kv_fused_train_plain,
    flash_cross_attention_kv_fused_fwd_lse,
    flash_cross_attention_kv_fused_precomputed,
    flash_cross_attention_kv_fused_train, keep_mask)
from parq_torch.kernels.pixel_align import _sampler_backward

import torch_common  # noqa: F401


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


@pytest.mark.parametrize("bounds", [
    [(0, 20), (20, 48)], [(0, 16), (16, 32), (32, 41)],
    [(0, 16), (16, 32), (32, 48), (48, 60)]])
def test_split_forward_keeps_the_unsplit_mask(rng, bounds):
    """(a) the split-KV plain forward under dropout draws with the GLOBAL
    kv column: its kept set is exactly the unsplit plain form's (and so
    the JAX kernel's), and o and lse agree to 1e-6."""
    B, H, Q, D, rate = 2, 2, 16, 64, 0.1
    N = bounds[-1][1]
    q, kv = _unit_v_inputs(rng, B, H, Q, N, D)
    seeds = torch.tensor([123457, 124434], dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(kv), seeds, rate)
    o, lse = cross_attention_kv_fused_train_plain(*args)
    o_s, lse_s = cross_attention_kv_fused_split_plain(*args, bounds)
    kept = o[..., :N] != 0.0
    assert torch.equal(o_s[..., :N] != 0.0, kept)
    assert 0.8 < kept.float().mean() < 0.97
    torch.testing.assert_close(o_s, o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse_s, lse, rtol=0, atol=1e-6)


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


def _uvs_rows(uv, rng):
    """(B, T, Q, 2) coordinates -> (B, T, Q, 4) rows with a per-query scale."""
    B, T, Q, _ = uv.shape
    scale = np.broadcast_to(rng.rand(B, 1, Q, 1) + 0.25, (B, T, Q, 1))
    return np.concatenate([uv, scale, np.zeros((B, T, Q, 1))], -1
                          ).astype(np.float32)


def _delicate_uv(case, rng, B, T, H, W):
    """Coordinates that a per-pixel gather must get right: see the cases
    of `test_sampler_bwd_mem_delicate_inputs_match_jax`."""
    if case == "one_pixel":
        return np.broadcast_to([2.25, 3.5], (B, T, 40, 2))
    if case == "borders":
        # exactly on the first and last pixel, half a pixel outside them
        # (one tap row or column in, one out), and around x, y = 8, where
        # the card's 8 x 8 tiles meet
        xs = [0.0, W - 1.0, -0.5, W - 0.5, -1.0, float(W), 7.0, 7.5, 8.0]
        ys = [0.0, H - 1.0, -0.5, H - 0.5, -1.0, float(H), 7.0, 7.5, 8.0]
        grid = np.array([(x, y) for x in xs for y in ys])
        return np.broadcast_to(grid, (B, T, len(grid), 2))
    if case == "off_image":
        uv = np.stack([W + 0.5 + 50 * rng.rand(B, T, 24),
                       -1.5 - 50 * rng.rand(B, T, 24)], -1)
        uv[0, :, 0] = [1e6, -3e5]
        uv[0, :, 1] = [-1.0 - 1e-3, 3.0]     # just past the last tap column
        return uv
    assert case == "single_query"
    return rng.rand(B, T, 1, 2) * [W - 1.0, H - 1.0]


@pytest.mark.parametrize("case", ["one_pixel", "borders", "off_image",
                                  "single_query"])
def test_sampler_bwd_mem_delicate_inputs_match_jax(rng, case):
    """(d) B4's plain version against the Pallas kernel, f32, atol 1e-5, on
    every query landing on one pixel; coordinates exactly on 0, W-1, H-1,
    just outside them and at a tile border; every query off the image (the
    result is all zeros); Q = 1."""
    B, T, H, W, C = 2, 3, 12, 16, 16
    uvs = _uvs_rows(_delicate_uv(case, rng, B, T, H, W), rng)
    g = rng.randn(B, uvs.shape[2], C).astype(np.float32)
    want = np.asarray(_pallas_sample_bwd_mem(
        jnp.asarray(uvs), jnp.asarray(g), (B, T, H, W, C), jnp.float32))
    got = sample_views_bwd_mem(torch.from_numpy(uvs), torch.from_numpy(g),
                               (B, T, H, W, C), torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if case == "off_image":
        assert not got.any() and not want.any()
    else:
        assert np.abs(got).max() > 0.1
    if case == "one_pixel":        # 4 taps: pixels (2..3, 3..4), nothing else
        touched = np.abs(got).sum(-1) > 0
        assert touched.sum() == B * T * 4 and touched[:, :, 3:5, 2:4].all()


@hypothesis.settings(max_examples=8, deadline=None, derandomize=True)
@hypothesis.given(B=st.integers(1, 2), T=st.integers(1, 3),
                  H=st.integers(1, 11), W=st.integers(2, 18),
                  Q=st.integers(1, 40), seed=st.integers(0, 2 ** 16))
def test_sampler_bwd_mem_random_shapes_match_jax(B, T, H, W, Q, seed):
    """(d) the same agreement, f32, atol 1e-5, over random small
    (B, T, H, W, Q), coordinates from 3 pixels outside the image inwards."""
    rng = np.random.RandomState(seed)
    uv = rng.rand(B, T, Q, 2) * [W + 6.0, H + 6.0] - 3.0
    uvs = _uvs_rows(uv, rng)
    g = rng.randn(B, Q, 8).astype(np.float32)
    want = _pallas_sample_bwd_mem(jnp.asarray(uvs), jnp.asarray(g),
                                  (B, T, H, W, 8), jnp.float32)
    got = sample_views_bwd_mem(torch.from_numpy(uvs), torch.from_numpy(g),
                               (B, T, H, W, 8), torch.float32)
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

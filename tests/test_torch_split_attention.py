"""B2 and B3 on separate K and V operands, and the v2 dropout hash: the
port's plain versions against the JAX package on the CPU, f32 (the Pallas
kernels in interpret mode):

(a) the v2 keep mask, bit for bit, read off the JAX kernel's output;
(b) `flash_cross_attention`, `_fwd_lse` and `_precomputed` in the natural
    (B, N, H·D) layout, the legacy (B, H, N, D) one and the legacy one with
    a pre-transposed (B, H, D, N) K, with n_valid < N, under dropout with
    the v1 and the v2 hash: forward within 2e-5, gradients within 5e-5
    (the tolerance of tests/test_seq_parallel.py:174);
(c) `b_offset`: a call on rows b0.. of a batch with b_offset = b0 draws
    the rows of the whole batch's call, bit for bit (the data-parallel
    contract), fused and split, forward and backward;
(d) `pad_kv_for_flash` pads as the JAX package's does.

JAX reads PARQ_DROPOUT_HASH when it traces a kernel; the fixture clears
JAX's caches around every test that sets it, so no trace of the other hash
is reused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.kernels import cross_attention_pallas as jca

from parq_torch.kernels import cross_attention as ca

import torch_common  # noqa: F401

B, H, Q, D = 2, 2, 16, 64
RATE = 0.3
SEEDS = [123457, 98765]          # 2 seed groups of Q/2 rows


@pytest.fixture(params=["v1", "v2"])
def hash_version(request, monkeypatch):
    monkeypatch.setenv("PARQ_DROPOUT_HASH", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def _layout_inputs(rng, layout, N):
    """(q, k, v) numpy f32 in `layout`; k of the legacy_kt layout is
    (B, H, D, N)."""
    q = rng.randn(B, H, Q, D).astype(np.float32)
    if layout == "natural":
        k, v = (rng.randn(B, N, H * D).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(2))
        if layout == "legacy_kt":
            k = np.ascontiguousarray(np.swapaxes(k, -1, -2))
    return q, 0.5 * k, v


def test_v2_keep_mask_is_the_jax_kernels_bits(rng, monkeypatch):
    """(a) exact, with the JAX kernel's kept weights: logits near 0 and V
    rows e_n, so o[.., q, n] ≠ 0 exactly where (q, n) is kept."""
    monkeypatch.setenv("PARQ_DROPOUT_HASH", "v2")
    jax.clear_caches()
    N, G = 56, 2
    q = (rng.randn(B, H, Q, D) * 0.01).astype(np.float32)
    k = (rng.randn(B, N, H * D) * 0.01).astype(np.float32)
    v = np.zeros((B, N, H, D), np.float32)
    v[:, np.arange(N), :, np.arange(N)] = 1.0
    v = v.reshape(B, N, H * D)
    o, _ = jca.flash_cross_attention_fwd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_rate=RATE,
        dropout_seed=jnp.asarray(SEEDS, jnp.int32), block_k=16,
        interpret=True)
    jax.clear_caches()
    jax_keep = np.asarray(o)[..., :N] != 0.0
    bh = torch.arange(B * H).view(B, H, 1)
    port = ca.keep_mask(torch.tensor(SEEDS).view(1, 1, G), bh, Q // G, N,
                        RATE, v2=True).reshape(B, H, Q, N).numpy()
    np.testing.assert_array_equal(port, jax_keep)
    assert 0.6 < port.mean() < 0.8
    v1 = ca.keep_mask(torch.tensor(SEEDS).view(1, 1, G), bh, Q // G, N,
                      RATE).reshape(B, H, Q, N).numpy()
    assert (v1 != port).mean() > 0.2         # the two hashes differ


@pytest.mark.parametrize("layout", ["natural", "legacy", "legacy_kt"])
def test_split_entries_match_jax(rng, layout, hash_version):
    """(b) forward (o, lse), and the gradients of `flash_cross_attention`
    and of `flash_cross_attention_precomputed`, against the JAX entries."""
    N, n_valid = (40, 40) if layout == "natural" else (48, 40)
    q, k, v = _layout_inputs(rng, layout, N)
    g = rng.randn(B, H, Q, D).astype(np.float32)
    kw = dict(n_valid=n_valid, dropout_rate=RATE,
              k_transposed=layout == "legacy_kt")
    jkw = dict(kw, dropout_seed=jnp.asarray(SEEDS, jnp.int32), block_k=16,
               interpret=True)
    pkw = dict(kw, dropout_seed=SEEDS)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    jo, jl = jca.flash_cross_attention_fwd_lse(jq, jk, jv, **jkw)
    to = lambda a: torch.from_numpy(np.array(a))                # noqa: E731
    po, pl = ca.flash_cross_attention_fwd_lse(to(q), to(k), to(v), **pkw)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl)[..., 0], rtol=0,
                               atol=2e-5)

    def jax_grads(fn):
        out, vjp = jax.vjp(fn, jq, jk, jv)
        return out, vjp(jnp.asarray(g))

    def port_grads(fn):
        args = [to(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*args)
        out.backward(torch.from_numpy(g))
        return out.detach(), [a.grad for a in args]

    cases = {
        "train": (lambda a, b, c: jca.flash_cross_attention(a, b, c, **jkw),
                  lambda a, b, c: ca.flash_cross_attention(a, b, c, **pkw)),
        "precomputed": (
            lambda a, b, c: jca.flash_cross_attention_precomputed(
                a, b, c, jo, jl, **jkw),
            lambda a, b, c: ca.flash_cross_attention_precomputed(
                a, b, c, po, pl, **pkw)),
    }
    for name, (jfn, pfn) in cases.items():
        jout, jg = jax_grads(jfn)
        pout, pg = port_grads(pfn)
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=0,
                                   atol=2e-5, err_msg=name)
        for what, a, b in zip("qkv", pg, jg):
            assert a.shape == b.shape, (name, what)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=5e-5, err_msg=f"{name} d{what}")
        if n_valid < N:          # rows past n_valid get no gradient
            dv = pg[2].numpy()
            assert not dv[:, :, n_valid:].any()


@pytest.mark.parametrize("form", ["fused", "split"])
def test_b_offset_draws_the_global_batch(rng, form):
    """(c) two calls of 2 rows each, b_offset 0 and 2, equal the rows of one
    call over 4 rows, forward and backward, bit for bit."""
    Bg, N, rate = 4, 24, 0.4
    q = torch.from_numpy(rng.randn(Bg, H, Q, D).astype(np.float32))
    do = torch.from_numpy(rng.randn(Bg, H, Q, D).astype(np.float32))
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    if form == "fused":
        kv = torch.from_numpy(rng.randn(Bg, N, 2 * H * D).astype(np.float32))

        def run(rows, b_offset):
            o, lse = ca.flash_fwd_lse(q[rows], kv[rows], seeds, rate,
                                      b_offset)
            delta = (do[rows] * o).sum(-1)
            return (o, lse) + ca.flash_bwd(q[rows], kv[rows], do[rows], lse,
                                           delta, seeds, rate, b_offset)
    else:
        k, v = (torch.from_numpy(rng.randn(Bg, N, H * D).astype(np.float32))
                for _ in range(2))

        def run(rows, b_offset):
            kh, vh = (ca.heads_view(t[rows], H, N) for t in (k, v))
            o, lse = ca.flash_fwd_lse_kv(q[rows], kh, vh, seeds, rate,
                                         b_offset)
            dk, dv = torch.empty_like(k[rows]), torch.empty_like(v[rows])
            dq = ca.flash_bwd_kv(q[rows], kh, vh, do[rows], lse,
                                 (do[rows] * o).sum(-1), seeds, rate,
                                 ca.heads_view(dk, H, N),
                                 ca.heads_view(dv, H, N), b_offset)
            return o, lse, dq, dk, dv
    whole = run(slice(0, 4), 0)
    parts = [run(slice(0, 2), 0), run(slice(2, 4), 2)]
    for i, w in enumerate(whole):
        assert torch.equal(torch.cat([p[i] for p in parts]), w), i
    shifted = run(slice(2, 4), 0)          # the local index draws others
    assert not torch.equal(shifted[0], whole[0][2:])


def test_pad_kv_for_flash_matches_jax(rng):
    """(d) the padded shapes and values of the JAX package's helper."""
    k_t = rng.randn(B, H, D, 200).astype(np.float32)
    v = rng.randn(B, H, 200, D).astype(np.float32)
    jk, jv = jca.pad_kv_for_flash(jnp.asarray(k_t), jnp.asarray(v))
    pk, pv = ca.pad_kv_for_flash(torch.from_numpy(k_t), torch.from_numpy(v))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))

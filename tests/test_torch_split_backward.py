"""B3's dq pass split over KV ranges, on the CPU: the plain split version
(`cross_attention_kv_fused_bwd_split_plain`: one f32 partial of dq per run
of whole 64-token blocks, added in split order) against `jax.vjp` of the
JAX package's `flash_cross_attention_kv_fused_train` (Pallas in interpret
mode) at 2, 3 and 4 splits with a ragged last run, dropout 0.1 and 0, f32,
atol 1e-5; the split rule `dq_splits`; and the wrapper's refusal of a
split the kernels do not take."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.kernels.cross_attention_pallas import (
    flash_cross_attention_kv_fused_train as j_train)

from parq_torch.kernels.cross_attention import (
    MAX_SPLITS, _splits_for, cross_attention_kv_fused_bwd_plain,
    cross_attention_kv_fused_bwd_split_plain,
    cross_attention_kv_fused_train_plain, dq_splits, kv_splits,
    split_bounds)

import torch_common  # noqa: F401

B, H, Q, N, D = 2, 2, 16, 500, 64   # 8 blocks of 64 tokens, the last 52
SEEDS = [31, 97]                     # 2 seed groups of 8 rows


def _inputs():
    rng = np.random.RandomState(0)
    q = rng.randn(B, H, Q, D).astype(np.float32)
    kv = (rng.randn(B, N, 2 * H * D) * 0.5).astype(np.float32)
    do = rng.randn(B, H, Q, D).astype(np.float32)
    return q, kv, do


@functools.lru_cache(maxsize=None)
def _jax_grads(rate):
    q, kv, do = _inputs()
    f = lambda a, b: j_train(a, b, dropout_rate=rate,
                             dropout_seed=jnp.asarray(SEEDS, jnp.int32),
                             block_k=32, interpret=True)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(kv))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _port_grads(rate, bounds):
    q, kv, do = (torch.from_numpy(a) for a in _inputs())
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    o, lse = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    delta = (do * o).sum(-1)
    if bounds is None:
        return cross_attention_kv_fused_bwd_plain(q, kv, do, lse, delta,
                                                  seeds, rate)
    return cross_attention_kv_fused_bwd_split_plain(q, kv, do, lse, delta,
                                                    seeds, rate, bounds)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("splits", [2, 3, 4])
def test_split_backward_matches_jax_vjp(splits, rate):
    """dq summed per KV range and dKV against the JAX backward, f32, atol
    1e-5; the last range is ragged."""
    bounds = split_bounds(N, splits)
    assert len(bounds) == splits and bounds[-1][1] == N
    assert (bounds[-1][1] - bounds[-1][0]) % 64        # the ragged run
    dq, dkv = _port_grads(rate, bounds)
    jdq, jdkv = _jax_grads(rate)
    np.testing.assert_allclose(dq.numpy(), jdq, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dkv.numpy(), jdkv, atol=1e-5, rtol=0)


@pytest.mark.parametrize("splits", [2, 3, 4])
def test_split_backward_changes_only_dq_order(splits):
    """The split touches dq alone: dKV equals the unsplit plain version's
    bit for bit, and dq differs from it by f32 rounding only."""
    dq, dkv = _port_grads(0.1, split_bounds(N, splits))
    dq1, dkv1 = _port_grads(0.1, None)
    assert torch.equal(dkv, dkv1)
    torch.testing.assert_close(dq, dq1, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B_,H_,Q_,N_,sms,want", [
    (8, 4, 2048, 14400, 132, 1),   # the release fold: 512 dq CTAs
    (8, 4, 2048, 7200, 132, 1),    # the fold on an SP rank's shard
    (8, 4, 256, 14400, 132, 2),    # release B=8, one iteration (REMAT)
    (1, 4, 256, 28800, 132, 16),   # scaled, one iteration: 128 CTAs
    (1, 4, 4096, 28800, 132, 1),   # scaled, folded (16 iterations)
    (1, 4, 256, 14400, 132, 15),   # B=1 at the release N: 225 blocks
    (1, 4, 256, 200, 132, 4),      # 4 blocks: no more splits than blocks
    (1, 4, 256, 40, 132, 1),       # below one block
])
def test_dq_split_rule(B_, H_, Q_, N_, sms, want):
    """`dq_splits` is a fixed function of the shape and the SM count: the
    most splits, up to MAX_SPLITS, that keep the dq CTAs within the SMs,
    each split owning at least one block."""
    got = dq_splits(B_, H_, Q_, N_, sms)
    assert got == want and 1 <= got <= MAX_SPLITS
    assert got == kv_splits(B_, H_, Q_, N_, sms)
    ctas = B_ * H_ * -(-Q_ // 128)
    assert got == 1 or ctas * got <= sms
    bounds = split_bounds(N_, got)
    assert len(bounds) == got and bounds[0][0] == 0 and bounds[-1][1] == N_
    assert all(a < b and a % 64 == 0 for a, b in bounds)


def test_wrapper_refuses_a_split_the_kernels_do_not_take():
    """Only bf16 at D = 256 splits; a split must own a block and stay
    within MAX_SPLITS. The rule is not consulted when a split is given, so
    this needs no card."""
    q = torch.zeros(1, 4, 256, 256, dtype=torch.bfloat16)
    assert _splits_for(q, 28800, 256, 16) == 16
    for splits, n in ((MAX_SPLITS + 1, 28800), (0, 28800), (3, 100)):
        with pytest.raises(ValueError, match="splits"):
            _splits_for(q, n, 256, splits)
    for bad in (q.float(), q[..., :128]):
        assert _splits_for(bad, 28800, 256, 1) == 1
        with pytest.raises(ValueError, match="bf16 D=256"):
            _splits_for(bad, 28800, 256, 2)

"""The plain versions of the port's two kernels against the JAX package:
sampler (B1) vs ops/pixel_align.py and the Pallas kernel in interpret
mode; flash cross-attention (B2) vs the fused Pallas forward in interpret
mode (online-max form) and cross_attention_reference; the plain split-KV
forward (partials over token ranges merged by `merge_partials`) vs the
same Pallas forward run unsplit. f32, atol 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from parq_tpu.geometry import Camera as JCamera, Pose as JPose
from parq_tpu.kernels import pixel_aligned_features_pallas
from parq_tpu.kernels.cross_attention_pallas import (
    cross_attention_reference, flash_cross_attention_kv_fused as j_flash,
    flash_cross_attention_kv_fused_fwd_lse as j_fwd_lse)
from parq_tpu.ops.pixel_align import pixel_aligned_features as j_sampler

from parq_torch.geometry import Camera, Pose
from parq_torch.kernels import (flash_cross_attention_kv_fused,
                                pixel_aligned_features_kernel, sample_views)
from parq_torch.kernels.cross_attention import (
    MAX_SPLITS, cross_attention_kv_fused_split_plain, kv_splits,
    split_bounds, split_kv)
from parq_torch.kernels.pixel_align import (project_uvs, sample_views_plain,
                                            sample_views_sums)
from parq_torch.ops.pixel_align import pixel_aligned_features

ATOL = 1e-5


def _scene(rng, case, B=2, T=3, H=6, W=8, C=16, Q=12):
    feats = rng.randn(B, T, H, W, C).astype(np.float32)
    cam = np.tile(np.array([W, H, 4.0, 4.0, W / 2, H / 2], np.float32),
                  (B, T, 1))
    poses = []
    for t in range(T):
        th = 0.1 * t
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        poses.append(np.concatenate([R.reshape(9), [0.1 * t, 0, 0]]))
    tcl = np.broadcast_to(np.stack(poses), (B, T, 12)).astype(np.float32)
    q = rng.rand(B, Q, 3).astype(np.float32) * [6, 4, 2] - [3, 2, -1.5]
    if case == "off_image":       # most taps fall off the map
        q[..., :2] *= 3.0
    elif case == "behind":        # some points behind every camera
        q[:, ::3, 2] = -2.0
    elif case == "all_invalid":
        q[..., 2] = -5.0
    return feats, q.astype(np.float32), tcl, cam, (W, H)


@pytest.mark.parametrize("case", ["mixed", "off_image", "behind",
                                  "all_invalid"])
def test_sampler_matches_jax(rng, case):
    feats, q, tcl, cam, fs = _scene(rng, case)
    jargs = (jnp.asarray(feats), jnp.asarray(q), JPose(jnp.asarray(tcl)),
             JCamera(jnp.asarray(cam)), fs)
    targs = (torch.from_numpy(feats), torch.from_numpy(q),
             Pose(torch.from_numpy(tcl)), Camera(torch.from_numpy(cam)), fs)
    want, want_im, want_valid = j_sampler(*jargs)
    pallas, _, _ = pixel_aligned_features_pallas(*jargs, force=True)
    for port in (pixel_aligned_features, pixel_aligned_features_kernel):
        got, got_im, got_valid = port(*targs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_im.numpy(), np.asarray(want_im),
                                   rtol=1e-6, atol=ATOL)
        np.testing.assert_array_equal(got_valid.numpy(),
                                      np.asarray(want_valid))
    if case == "all_invalid":
        assert not got_valid.any()
    else:
        assert got_valid.any()


@pytest.mark.parametrize("T", [3, 6])
@pytest.mark.parametrize("case", ["mixed", "behind", "off_image"])
def test_sampler_matches_jax_at_batch_1(rng, T, case):
    """B=1, the eval twin's and the scaled config's batch, at their view
    counts (3 and 6): the port's sampler (plain sums through the kernel's
    wrapper) against JAX's op and its Pallas kernel in interpret mode."""
    feats, q, tcl, cam, fs = _scene(rng, case, B=1, T=T, Q=20)
    jargs = (jnp.asarray(feats), jnp.asarray(q), JPose(jnp.asarray(tcl)),
             JCamera(jnp.asarray(cam)), fs)
    want, _, want_valid = j_sampler(*jargs)
    pallas, _, _ = pixel_aligned_features_pallas(*jargs, force=True)
    got, _, got_valid = pixel_aligned_features_kernel(
        torch.from_numpy(feats), torch.from_numpy(q),
        Pose(torch.from_numpy(tcl)), Camera(torch.from_numpy(cam)), fs)
    assert got.dtype == torch.float32 and got.shape == (1, 20, feats.shape[-1])
    for ref in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sample_views_returns_the_memory_dtype(rng, dtype):
    """B1 writes the memory's dtype: on the CPU the f32 plain sums cast
    once, bit for bit (on the card the kernel rounds its f32 sums the same
    way, tests/test_torch_cuda.py). The features of the model's sampler
    entries come back in that dtype with no further cast."""
    feats, q, tcl, cam, fs = _scene(rng, "mixed", B=1, T=3, Q=16)
    uvs, _, _ = project_uvs(torch.from_numpy(q), Pose(torch.from_numpy(tcl)),
                            Camera(torch.from_numpy(cam)))
    mem = torch.from_numpy(feats).to(dtype)
    got = sample_views(mem, uvs)
    assert got.dtype == dtype
    sums = sample_views_plain(mem, uvs)
    assert sums.dtype == torch.float32
    assert torch.equal(got, sums.to(dtype))
    assert torch.equal(sample_views_sums(mem, uvs), sums)
    feats_k, _, _ = pixel_aligned_features_kernel(
        mem, torch.from_numpy(q), Pose(torch.from_numpy(tcl)),
        Camera(torch.from_numpy(cam)), fs)
    assert feats_k.dtype == dtype and torch.equal(feats_k, got)


def test_sampler_train_entry_hands_b4_the_memory_dtype(rng, monkeypatch):
    """In training the sampler's cotangent reaches B4's wrapper in the
    memory's dtype (so its cast of g copies nothing), and the gradients
    equal those through an f32 output cast afterwards, bit for bit."""
    from parq_torch.kernels import pixel_align as pa
    feats, q, tcl, cam, fs = _scene(rng, "mixed", B=1, T=3, Q=16)
    mem = torch.from_numpy(feats).bfloat16().requires_grad_(True)
    qp = torch.from_numpy(q).requires_grad_(True)
    seen = []
    bwd = pa.sample_views_bwd_mem

    def watched(uvs, g, mem_shape, dtype):
        seen.append(g.dtype)
        return bwd(uvs, g, mem_shape, dtype)
    monkeypatch.setattr(pa, "sample_views_bwd_mem", watched)
    g = torch.from_numpy(rng.randn(1, 16, feats.shape[-1]).astype(np.float32))
    out, _, _ = pa.pixel_aligned_features_train(
        mem, qp, Pose(torch.from_numpy(tcl)), Camera(torch.from_numpy(cam)),
        fs)
    assert out.dtype == torch.bfloat16
    dmem, dq = torch.autograd.grad(out, (mem, qp), g.bfloat16())
    assert seen == [torch.bfloat16]
    # the same through the f32 sums, cast to bf16 after the custom function
    uvs, _, _ = project_uvs(qp, Pose(torch.from_numpy(tcl)),
                            Camera(torch.from_numpy(cam)))
    ref = pa._sampler_backward(mem.detach(), uvs.detach(),
                               g.bfloat16().float(), None)
    assert torch.equal(dmem, ref[0])
    want_dq, = torch.autograd.grad(uvs, qp, ref[1])
    assert torch.equal(dq, want_dq)


def test_sampler_sums_invalid_views(rng):
    """The view sum covers every view; only the divisor counts valid
    ones. A query valid in one view but with in-image taps in another
    invalid (off-image) view keeps that view's contribution."""
    B, T, H, W, C = 1, 2, 4, 4, 8
    mem = torch.from_numpy(rng.randn(B, T, H, W, C).astype(np.float32))
    # view 0: inside; view 1: u = -0.5 → invalid, but the tap at x=0 is in
    uvs = torch.tensor([[[[1.0, 1.0, 1.0, 0.0]], [[-0.5, 2.0, 1.0, 0.0]]]])
    got = sample_views_plain(mem, uvs)
    want = mem[0, 0, 1, 1] + 0.5 * mem[0, 1, 2, 0]
    np.testing.assert_allclose(got[0, 0].numpy(), want.numpy(), atol=ATOL)


def test_sample_views_cpu_is_plain(rng):
    feats, q, tcl, cam, _ = _scene(rng, "mixed")
    uvs, _, _ = project_uvs(torch.from_numpy(q), Pose(torch.from_numpy(tcl)),
                            Camera(torch.from_numpy(cam)))
    mem = torch.from_numpy(feats)
    before = sample_views.launches
    torch.testing.assert_close(sample_views(mem, uvs),
                               sample_views_plain(mem, uvs), rtol=0, atol=0)
    assert sample_views.launches == before     # plain path: no launch


@pytest.mark.parametrize("N", [300, 1000])
def test_attention_matches_jax(rng, monkeypatch, N):
    monkeypatch.setenv("PARQ_ATTN_STATICMAX", "0")   # online-max form
    B, H, Q, D = 2, 2, 16, 128
    q = rng.randn(B, H, Q, D).astype(np.float32)
    kv = (rng.randn(B, N, 2 * H * D) * 0.3).astype(np.float32)
    got = flash_cross_attention_kv_fused(torch.from_numpy(q),
                                         torch.from_numpy(kv))
    pallas = j_flash(jnp.asarray(q), jnp.asarray(kv), block_k=128,
                     interpret=True)
    k, v = split_kv(torch.from_numpy(kv), H)
    ref = cross_attention_reference(jnp.asarray(q), jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()))
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)



@pytest.mark.parametrize("splits", [2, 3, 4])
def test_split_forward_matches_jax_unsplit(rng, monkeypatch, splits):
    """The split-KV forward's plain version (one partial per run of whole
    64-token blocks, the last ragged, merged by `merge_partials`) against
    the JAX flash kernel run unsplit: o and lse, f32, atol 1e-5."""
    monkeypatch.setenv("PARQ_ATTN_STATICMAX", "0")   # online-max form
    B, H, Q, N, D = 2, 2, 16, 500, 64
    q = rng.randn(B, H, Q, D).astype(np.float32)
    kv = (rng.randn(B, N, 2 * H * D) * 0.5).astype(np.float32)
    bounds = split_bounds(N, splits)
    assert len(bounds) == splits and bounds[-1] == (bounds[-1][0], N)
    assert (bounds[-1][1] - bounds[-1][0]) % 64        # the ragged run
    o, lse = cross_attention_kv_fused_split_plain(
        torch.from_numpy(q), torch.from_numpy(kv),
        torch.zeros(1, dtype=torch.int32), 0.0, bounds)
    jo, jl = j_fwd_lse(jnp.asarray(q), jnp.asarray(kv), block_k=128,
                       interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,H,rows,N,sms,want", [
    (8, 4, 256, 14400, 132, 2),    # release serving and phase-1 training
    (8, 4, 2048, 14400, 132, 1),   # one unfolded group of 2048 rows
    (1, 4, 256, 14400, 132, 4),    # few CTAs: the cap
    (1, 4, 256, 100, 132, 2),      # never more splits than 64-token blocks
    (2, 4, 200, 40, 132, 1),
])
def test_kv_split_rule(B, H, rows, N, sms, want):
    """`kv_splits` is a fixed function of the shape and the SM count, and
    every split it names owns at least one block."""
    got = kv_splits(B, H, rows, N, sms)
    assert got == want and 1 <= got <= MAX_SPLITS
    bounds = split_bounds(N, got)
    assert len(bounds) == got and bounds[0][0] == 0 and bounds[-1][1] == N
    assert all(a < b for a, b in bounds)
    assert all(a % 64 == 0 for a, _ in bounds)

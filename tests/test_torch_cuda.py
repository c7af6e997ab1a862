"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a machine without a GPU (the check runs
inside the fixture, never at import). On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine need
not have; these tests import only torch and parq_torch.)
"""
import pytest
import torch

from parq_torch.kernels import (flash_bwd, flash_cross_attention_kv_fused,
                                flash_fwd_lse, sample_views,
                                sample_views_bwd_mem)
from parq_torch.kernels.cross_attention import (
    cross_attention_kv_fused_bwd_plain, cross_attention_kv_fused_plain,
    cross_attention_kv_fused_train_plain)
from parq_torch.kernels.pixel_align import (sample_views_bwd_mem_plain,
                                            sample_views_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_kernel_matches_plain(gen, dtype):
    B, T, H, W, C, Q = 2, 3, 12, 16, 64, 37
    mem = torch.randn(B, T, H, W, C, device="cuda", generator=gen).to(dtype)
    uv = torch.rand(B, T, Q, 2, device="cuda", generator=gen)
    uv = uv * torch.tensor([W + 6.0, H + 6.0], device="cuda") - 3.0
    uv[0, :, 0] = 1e6          # far off the image (a point behind the camera)
    scale = torch.rand(B, 1, Q, 1, device="cuda", generator=gen)
    uvs = torch.cat([uv, scale.expand(B, T, Q, 1),
                     torch.zeros(B, T, Q, 1, device="cuda")], -1).contiguous()
    before = sample_views.launches
    got = sample_views(mem, uvs)
    torch.cuda.synchronize()
    assert sample_views.launches == before + 1
    torch.testing.assert_close(got, sample_views_plain(mem, uvs), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,D", [(1000, 256), (77, 64), (300, 128)])
def test_flash_kernel_matches_plain(gen, dtype, atol, N, D):
    B, H, Q = 2, 4, 40          # Q not a multiple of the 32-row tile
    # logits of std 2: a softmax far from uniform
    q = (2 * torch.randn(B, H, Q, D, device="cuda", generator=gen)).to(dtype)
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).to(dtype)
    got = flash_cross_attention_kv_fused(q, kv)
    torch.testing.assert_close(got.float(),
                               cross_attention_kv_fused_plain(q, kv).float(),
                               rtol=0, atol=atol)


def test_flash_kernel_extreme_logits_stay_finite(gen):
    """Logits far below any static shift: the online max keeps l ≥ 1."""
    B, H, Q, D, N = 1, 4, 32, 256, 500
    q = torch.randn(B, H, Q, D, device="cuda", generator=gen) * 40
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen) * 40
    got = flash_cross_attention_kv_fused(q, kv)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, cross_attention_kv_fused_plain(q, kv),
                               rtol=0, atol=1e-3 * float(kv.abs().max()))


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 4, 8, 96, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head dim"):
        flash_cross_attention_kv_fused(q, torch.randn(1, 5, 768,
                                                      device="cuda"))
    with pytest.raises(TypeError):
        flash_cross_attention_kv_fused(
            q[..., :64].contiguous(),
            torch.randn(1, 5, 512, device="cuda").half())
    mem = torch.randn(1, 1, 4, 4, 12, device="cuda")
    with pytest.raises(ValueError):
        sample_views(mem, torch.zeros(1, 1, 2, 4, device="cuda"))


def _seeds(G):
    return torch.tensor([11 + 7 * g for g in range(G)], dtype=torch.int32,
                        device="cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,D,Q,G", [(1000, 256, 40, 1), (77, 64, 48, 2),
                                     (300, 128, 96, 4)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_train_forward_matches_plain(gen, dtype, atol, N, D, Q, G,
                                           rate):
    """B2's train form: o, and lse to 1e-3 (f32 statistics in both)."""
    B, H = 2, 4
    q = (2 * torch.randn(B, H, Q, D, device="cuda", generator=gen)).to(dtype)
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).to(dtype)
    seeds = _seeds(G)
    o, lse = flash_fwd_lse(q, kv, seeds, rate)
    o_ref, lse_ref = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=atol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_train_folded_equals_separate_calls(gen, dtype):
    """G seed groups in one call draw exactly what G calls draw: o and
    lse are equal bit for bit."""
    B, H, Q0, G, N, D = 2, 4, 64, 4, 300, 256
    q = torch.randn(B, H, G * Q0, D, device="cuda", generator=gen).to(dtype)
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).to(dtype)
    seeds = _seeds(G)
    o, lse = flash_fwd_lse(q, kv, seeds, 0.1)
    for g in range(G):
        rows = slice(g * Q0, (g + 1) * Q0)
        og, lg = flash_fwd_lse(q[:, :, rows].contiguous(), kv,
                               seeds[g:g + 1], 0.1)
        assert torch.equal(o[:, :, rows], og)
        assert torch.equal(lse[:, :, rows], lg)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,D,Q,G", [(1000, 256, 64, 2), (77, 64, 40, 1),
                                     (300, 128, 96, 4)])
def test_flash_backward_matches_plain(gen, dtype, rtol, N, D, Q, G):
    """B3 against its plain version, relative to each output's largest
    element (bf16: ds and w round to bf16 in both, the sums' order
    differs)."""
    B, H, rate = 2, 4, 0.3
    q = (2 * torch.randn(B, H, Q, D, device="cuda", generator=gen)).to(dtype)
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).to(dtype)
    do = torch.randn(B, H, Q, D, device="cuda", generator=gen).to(dtype)
    seeds = _seeds(G)
    o, lse = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    delta = (do.float() * o.float()).sum(-1)
    before = flash_bwd.launches
    dq, dkv = flash_bwd(q, kv, do, lse, delta, seeds, rate)
    assert flash_bwd.launches == before + 1
    dq_ref, dkv_ref = cross_attention_kv_fused_bwd_plain(q, kv, do, lse,
                                                         delta, seeds, rate)
    for got, want in ((dq, dq_ref), (dkv, dkv_ref)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_bwd_kernel_matches_plain(gen, dtype):
    """B4 against its plain version: both sum in f32; atomics change the
    order, so f32 agrees to 1e-5 and bf16 to one bf16 rounding."""
    B, T, H, W, C, Q = 2, 3, 12, 16, 64, 37
    uv = torch.rand(B, T, Q, 2, device="cuda", generator=gen)
    uv = uv * torch.tensor([W + 6.0, H + 6.0], device="cuda") - 3.0
    uv[0, :, 0] = 1e6          # far off the image (a point behind the camera)
    scale = torch.rand(B, 1, Q, 1, device="cuda", generator=gen)
    uvs = torch.cat([uv, scale.expand(B, T, Q, 1),
                     torch.zeros(B, T, Q, 1, device="cuda")], -1).contiguous()
    g = torch.randn(B, Q, C, device="cuda", generator=gen)
    before = sample_views_bwd_mem.launches
    got = sample_views_bwd_mem(uvs, g, (B, T, H, W, C), dtype)
    torch.cuda.synchronize()
    assert sample_views_bwd_mem.launches == before + 1
    assert got.dtype == dtype
    want = sample_views_bwd_mem_plain(uvs, g, (B, T, H, W, C), dtype)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_train_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 4, 8, 64, device="cuda", generator=gen)
    kv = torch.randn(1, 5, 512, device="cuda", generator=gen)
    seeds = _seeds(1)
    with pytest.raises(TypeError):
        flash_fwd_lse(q, kv.bfloat16(), seeds, 0.1)
    lse = torch.zeros(1, 4, 8, device="cuda")
    with pytest.raises(ValueError, match="lse"):
        flash_bwd(q, kv, q, lse[..., :4], lse, seeds, 0.1)
    with pytest.raises(ValueError):
        sample_views_bwd_mem(torch.zeros(1, 1, 2, 4, device="cuda"),
                             torch.zeros(1, 2, 12, device="cuda"),
                             (1, 1, 4, 4, 12), torch.float32)

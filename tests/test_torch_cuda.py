"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a machine without a GPU (the check runs
inside the fixture, never at import). On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine need
not have; these tests import only torch and parq_torch.)
"""
import pytest
import torch

from parq_torch.kernels import (flash_cross_attention_kv_fused,
                                sample_views)
from parq_torch.kernels.cross_attention import cross_attention_kv_fused_plain
from parq_torch.kernels.pixel_align import sample_views_plain

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

"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a machine without a GPU (the check runs
inside the fixture, never at import). On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine need
not have; these tests import only torch and parq_torch.)
"""
import numpy as np
import pytest
import torch

from parq_torch.kernels import (flash_bwd, flash_cross_attention_kv_fused,
                                flash_fwd_lse, sample_views,
                                sample_views_bwd_mem)
from parq_torch.kernels.cross_attention import (
    MAX_SPLITS, _flash_bwd, _flash_bwd_kv, _flash_fwd, _flash_fwd_lse,
    attention_bwd_plain, cross_attention_kv_fused_bwd_plain,
    cross_attention_kv_fused_plain, cross_attention_kv_fused_train_plain,
    split_bounds, split_kv, wgmma_selftest)
from parq_torch.kernels.pixel_align import (sample_views_bwd_mem_plain,
                                            sample_views_plain,
                                            sample_views_sums)

import torch_common  # noqa: F401

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
    assert got.dtype == dtype              # B1 writes the memory's dtype
    sums = sample_views_sums(mem, uvs)
    torch.testing.assert_close(sums, sample_views_plain(mem, uvs), rtol=0,
                               atol=1e-4)
    assert torch.equal(got, sums.to(dtype))


def _sampler_case(gen, B, T, C, case, H=12, W=16, Q=40):
    """(u, v, scale) rows over and around an H x W map, none with a tap on
    pixel (0, 0): "mixed" (inside, on the edges and off them, a point
    behind the camera far off), "off" (every tap off the image), "behind"
    (every view of half the queries projected from behind the camera:
    coordinates near the float range's ends)."""
    uv = torch.rand(B, T, Q, 2, device="cuda", generator=gen)
    uv = uv * torch.tensor([W + 6.0, H + 6.0], device="cuda") - 3.0
    near = (uv > -1.0) & (uv < 1.0)      # no tap on pixel (0, 0)
    uv[..., 0] += 3.0 * (near[..., 0] & near[..., 1])
    uv[:, :, 0] = torch.tensor([W - 1.0, 0.0], device="cuda")
    uv[:, :, 1] = torch.tensor([0.0, H - 1.0], device="cuda")
    if case == "mixed":
        uv[:, 0, 2] = torch.tensor([-3e9, 1e30], device="cuda")
    elif case == "off":
        uv = uv + torch.tensor([W + 4.0, 0.0], device="cuda")
    elif case == "behind":
        uv[:, :, ::2] = torch.tensor([3e38, -1e38], device="cuda")
    scale = torch.rand(B, 1, Q, 1, device="cuda", generator=gen)
    return torch.cat([uv, scale.expand(B, T, Q, 1),
                      torch.zeros(B, T, Q, 1, device="cuda")], -1).contiguous()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("T", [1, 3, 6])
@pytest.mark.parametrize("C", [8, 64, 1024])
def test_sampler_kernel_at_batch_views_and_widths(gen, B, T, C):
    """B1 at B 1 and 8, 1, 3 and 6 views (the kernel loads 3 or 6 views'
    taps before its first FMA), 8 to 1024 channels (1 to 128 threads a
    query): bf16 and f32 against the plain version (the f32 sums to 1e-4),
    the bf16 output equal to its f32 sums rounded by torch, two launches
    equal bit for bit; every tap off the image and points behind the
    camera give exact zeros where no view has a tap inside. Pixel (0, 0),
    where an off-image tap's clamped address would land, is NaN: the
    kernel skips such a tap's load, so the NaN never reaches a sum."""
    for case in ("mixed", "off", "behind"):
        uvs = _sampler_case(gen, B, T, C, case)
        mem32 = torch.randn(B, T, 12, 16, C, device="cuda", generator=gen)
        mem32[:, :, 0, 0] = float("nan")
        for dtype in (torch.float32, torch.bfloat16):
            mem = mem32.to(dtype)
            got = sample_views(mem, uvs)
            assert got.dtype == dtype and got.shape == (B, 40, C)
            assert torch.equal(got, sample_views(mem, uvs))
            sums = sample_views_sums(mem, uvs)
            want = sample_views_plain(mem.nan_to_num(0.0), uvs)
            assert torch.isfinite(sums).all(), case
            torch.testing.assert_close(sums, want, rtol=0, atol=1e-4)
            assert torch.equal(got, sums.to(dtype))
            if case == "off":
                assert not got.any()
            if case == "behind":
                assert not got[:, ::2].any()


# The Hopper (wgmma + TMA) kernels take bf16 at D = 256. Their shapes: the
# release q tile count (256), a Q that does not divide the 128-row CTA tile
# (200) and the training fold (2048 rows in 8 seed groups), against the
# release token count, a ragged one and one below a 64-token KV tile.
HOPPER_QG = [(256, 1), (200, 1), (2048, 8)]
HOPPER_N = [14400, 1000, 40]


def _hopper_inputs(gen, Q, N, B=1, H=4, D=256):
    q = (2 * torch.randn(B, H, Q, D, device="cuda", generator=gen)).bfloat16()
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).bfloat16()
    return q, kv


def _splits(N):
    """Every KV split the wrapper may choose at N (B2's, and B3's dq
    pass's), and the rule's (None)."""
    return [None] + [s for s in range(1, MAX_SPLITS + 1)
                     if len(split_bounds(N, s)) == s]


def test_wgmma_building_blocks(gen):
    """hopper.cuh's descriptors on one tile: K-major x K-major from shared
    memory (f32 accumulate: 1e-5 of the max), then its bf16 rounding from
    registers times an MN-major tile (1e-2: a rounding of the first product
    may fall the other way)."""
    a, b, v = (torch.randn(64, n, device="cuda", generator=gen).bfloat16()
               for n in (64, 64, 256))
    for _ in range(3):      # a missing fence shows as a rare wrong number
        c1, c2 = wgmma_selftest(a, b, v)
        want1 = a.float() @ b.float().T
        want2 = want1.bfloat16().float() @ v.float()
        torch.testing.assert_close(c1, want1, rtol=0,
                                   atol=1e-5 * float(want1.abs().max()))
        torch.testing.assert_close(c2, want2, rtol=0,
                                   atol=1e-2 * float(want2.abs().max()))


@pytest.mark.parametrize("N", HOPPER_N)
@pytest.mark.parametrize("Q,G", HOPPER_QG)
def test_hopper_forward_matches_plain_at_every_split(gen, Q, G, N):
    """B2 (eval and train form, dropout 0.1) in bf16 at D = 256, at every
    KV split: o to 2e-2 plus one bf16 step of the value (with 40 tokens and
    dropout's 1/0.9, |o| passes 4, where a bf16 step is 0.031), lse to
    1e-4; run twice, the results equal bit for bit."""
    q, kv = _hopper_inputs(gen, Q, N)
    seeds = _seeds(G)
    want = cross_attention_kv_fused_plain(q, kv).float()
    o_ref, lse_ref = cross_attention_kv_fused_train_plain(q, kv, seeds, 0.1)
    for splits in _splits(N):
        got = _flash_fwd(q, kv, splits)
        torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=2e-2)
        o, lse = _flash_fwd_lse(q, kv, seeds, 0.1, splits)
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=2 ** -7,
                                   atol=2e-2)
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
        o2, lse2 = _flash_fwd_lse(q, kv, seeds, 0.1, splits)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("N", HOPPER_N)
@pytest.mark.parametrize("Q,G", HOPPER_QG)
def test_hopper_backward_matches_plain(gen, Q, G, N, rate):
    """B3 in bf16 at D = 256, at every KV split of its dq pass: dq and dKV
    to 2e-2 of their largest element; run twice, the results equal bit for
    bit (no atomics); dKV does not depend on the dq split."""
    q, kv = _hopper_inputs(gen, Q, N)
    do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    seeds = _seeds(G)
    o, lse = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    delta = (do.float() * o.float()).sum(-1)
    dq_ref, dkv_ref = cross_attention_kv_fused_bwd_plain(q, kv, do, lse,
                                                         delta, seeds, rate)
    before = flash_bwd.launches
    dq, dkv = flash_bwd(q, kv, do, lse, delta, seeds, rate)
    assert flash_bwd.launches == before + 1
    for splits in _splits(N):
        dq, dkv1 = _flash_bwd(q, kv, do, lse, delta, seeds, rate, splits)
        assert torch.equal(dkv1, dkv)
        for got, want in ((dq, dq_ref), (dkv, dkv_ref)):
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=2e-2 * float(want.abs().max()))
        dq2, dkv2 = _flash_bwd(q, kv, do, lse, delta, seeds, rate, splits)
        assert torch.equal(dq, dq2) and torch.equal(dkv, dkv2)


@pytest.mark.parametrize("N", [7200, 1000])
def test_hopper_split_kv_backward_at_every_dq_split(gen, N):
    """B3 on separate natural (B, N, H·D) K and V at B=1, Q=256, dropout
    0.1, at every dq split: dq and dK, dV to 2e-2 of their largest element,
    two launches equal bit for bit."""
    q, kv = _hopper_inputs(gen, 256, N)
    H = q.shape[1]
    k, v = (t.transpose(1, 2).contiguous().flatten(2)
            for t in split_kv(kv, H))
    kh, vh = (t.unflatten(-1, (H, 256)).transpose(1, 2) for t in (k, v))
    do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    seeds = _seeds(1)
    o, lse = cross_attention_kv_fused_train_plain(q, kv, seeds, 0.1)
    delta = (do.float() * o.float()).sum(-1)
    dk_ref, dv_ref = torch.empty_like(kh), torch.empty_like(vh)
    dq_ref = attention_bwd_plain(q, kh, vh, do, lse, delta, seeds, 0.1,
                                 dk_ref, dv_ref)
    for splits in _splits(N):
        outs = []
        for _ in range(2):
            dk, dv = (torch.empty_like(t) for t in (k, v))
            dkh, dvh = (t.unflatten(-1, (H, 256)).transpose(1, 2)
                        for t in (dk, dv))
            dq = _flash_bwd_kv(q, kh, vh, do, lse, delta, seeds, 0.1, dkh,
                               dvh, splits)
            outs.append((dq, dk, dv))
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        for got, want in ((dq, dq_ref), (dkh, dk_ref), (dvh, dv_ref)):
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=2e-2 * float(want.abs().max()))


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
    """B2's train form: o, and lse to 1e-4 (f32 statistics in both)."""
    B, H = 2, 4
    q = (2 * torch.randn(B, H, Q, D, device="cuda", generator=gen)).to(dtype)
    kv = torch.randn(B, N, 2 * H * D, device="cuda", generator=gen).to(dtype)
    seeds = _seeds(G)
    o, lse = flash_fwd_lse(q, kv, seeds, rate)
    o_ref, lse_ref = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=atol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("N", [300, 14400, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_train_folded_equals_separate_calls(gen, dtype, N):
    """G seed groups in one call draw exactly what G calls draw: o and
    lse are equal bit for bit (the KV split follows the rows of one group,
    so both sum in the same order)."""
    B, H, Q0, G, D = 2, 4, 64, 4, 256
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


def _bwd_uv(case, gen, B, T, H, W, Q):
    """(B, T, Q, 2) coordinates for B4: random with 3 pixels of margin and
    one point far off the image; every query on one pixel; the image's and
    the 8 x 8 tiles' borders; every query off the image."""
    rand = lambda *s: torch.rand(*s, device="cuda", generator=gen)
    if case == "random":
        uv = rand(B, T, Q, 2) * torch.tensor([W + 6.0, H + 6.0],
                                             device="cuda") - 3.0
        uv[0, :, 0] = 1e6      # far off the image (a point behind the camera)
        return uv
    if case == "one_pixel":
        return torch.tensor([2.25, 3.5], device="cuda").expand(B, T, Q, 2)
    if case == "borders":
        xs = torch.tensor([0.0, W - 1.0, -0.5, W - 0.5, -1.0, float(W), 7.0,
                           7.5, 8.0], device="cuda")
        ys = torch.tensor([0.0, H - 1.0, -0.5, H - 0.5, -1.0, float(H), 7.0,
                           7.5, 8.0], device="cuda")
        i = torch.arange(Q, device="cuda")
        return torch.stack([xs[i % 9], ys[(i // 9) % 9]], -1).expand(
            B, T, Q, 2)
    assert case == "off_image"
    return torch.cat([W + 0.5 + 50 * rand(B, T, Q, 1),
                      -1.5 - 50 * rand(B, T, Q, 1)], -1)


def _bwd_inputs(case, gen, B, T, H, W, C, Q):
    uv = _bwd_uv(case, gen, B, T, H, W, Q)
    scale = torch.rand(B, 1, Q, 1, device="cuda", generator=gen)
    uvs = torch.cat([uv, scale.expand(B, T, Q, 1),
                     torch.zeros(B, T, Q, 1, device="cuda")], -1).contiguous()
    return uvs, torch.randn(B, Q, C, device="cuda", generator=gen)


BWD_CASES = ["random", "one_pixel", "borders", "off_image"]
# (H, W, C, Q): maps that the 8 x 8 tile does not divide, a C of one 16-byte
# vector pair, a Q that is no multiple of a warp, Q = 1; a Q beyond one
# 2048-row chunk of the hit list with a C beyond one 1024-channel slab
BWD_SHAPES = [(12, 16, 64, 37), (6, 8, 16, 81), (9, 17, 1024, 100),
              (13, 10, 64, 1), (9, 17, 1032, 4500)]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("H,W,C,Q", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_bwd_kernel_matches_plain(gen, dtype, H, W, C, Q, case):
    """B4 against its plain version: both sum in f32, in different orders,
    so f32 agrees to 1e-5 of the largest element and bf16 to one bf16
    rounding of it (1e-2)."""
    B, T = 2, 3
    uvs, g = _bwd_inputs(case, gen, B, T, H, W, C, Q)
    before = sample_views_bwd_mem.launches
    got = sample_views_bwd_mem(uvs, g, (B, T, H, W, C), dtype)
    torch.cuda.synchronize()
    assert sample_views_bwd_mem.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, T, H, W, C)
    want = sample_views_bwd_mem_plain(uvs, g, (B, T, H, W, C), dtype)
    if case == "off_image":
        assert not got.any() and not want.any()
        return
    limit = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=limit * float(want.abs().max()))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_bwd_kernel_is_reproducible(gen, dtype, case):
    """Every pixel's taps are added in q order by one warp, with no
    atomics: two launches on the same inputs are equal bit for bit, and
    the result does not depend on what the output buffer held."""
    B, T, H, W, C, Q = 2, 3, 30, 40, 1024, 2048
    uvs, g = _bwd_inputs(case, gen, B, T, H, W, C, Q)
    first = sample_views_bwd_mem(uvs, g, (B, T, H, W, C), dtype)
    del first
    # the allocator hands the next call the same block, now full of values
    torch.empty((B, T, H, W, C), dtype=dtype, device="cuda").fill_(7.0)
    a = sample_views_bwd_mem(uvs, g, (B, T, H, W, C), dtype)
    b = sample_views_bwd_mem(uvs, g, (B, T, H, W, C), dtype)
    assert torch.equal(a, b)
    want = sample_views_bwd_mem_plain(uvs, g, (B, T, H, W, C), dtype)
    limit = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(a.float(), want.float(), rtol=0,
                               atol=limit * float(want.abs().max()))


def test_sampler_bwd_kernel_ignores_nan_rows(gen):
    """A NaN coordinate fails the float bounds test and adds nothing."""
    B, T, H, W, C, Q = 1, 2, 12, 16, 64, 40
    uvs, g = _bwd_inputs("random", gen, B, T, H, W, C, Q)
    want = sample_views_bwd_mem_plain(uvs[:, :, 8:].contiguous(), g[:, 8:],
                                      (B, T, H, W, C), torch.float32)
    uvs[:, :, :8, :2] = float("nan")
    got = sample_views_bwd_mem(uvs, g, (B, T, H, W, C), torch.float32)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_backbone_tokens_keep_the_compute_dtype(gen):
    """Under bf16 autocast the backbone's tokens are bf16, as in the JAX
    model, so the sampler kernels run their bf16 forms (CUDA autocast runs
    F.interpolate in float32; the backbone resizes outside it). Against
    the f32 run: a few bf16 roundings of the largest token."""
    from parq_torch.models.resnet_fpn import ResNetFPN
    net = ResNetFPN("resnet18", 32).cuda().eval()
    images = torch.rand(1, 2, 64, 96, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        want = net(images)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = net(images)
    assert want.dtype == torch.float32 and got.dtype == torch.bfloat16
    assert got.shape == want.shape == (1, 2, 16, 24, 128)
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=5e-2 * float(want.abs().max()))


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


# ------------------------------------------ the train.py / eval.py twins --
def test_nms_mask_device_on_card_equals_cpu(gen):
    from parq_torch.evals import nms_mask_device
    K = 64
    lo = torch.rand(K, 3, device="cuda", generator=gen) * 4
    hi = lo + 0.3 + torch.rand(K, 3, device="cuda", generator=gen)
    signs = torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)],
                         device="cuda")
    corners = torch.where(signs.bool()[None], hi[:, None], lo[:, None])
    scores = torch.randperm(K, device="cuda", generator=gen).float() / K
    labels = torch.randint(0, 10, (K,), device="cuda", generator=gen)
    for same in (False, True):
        got = nms_mask_device(corners, scores, labels, 9, 0.1, same)
        want = nms_mask_device(corners.cpu(), scores.cpu(), labels.cpu(), 9,
                               0.1, same)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


def _nms_args(case, gen, valid_share=1.0):
    """The NMS kernel's arguments for an NMS case of torch_common, on the
    CPU: the case's corners, scores and labels, random obb data, world
    corners and class probabilities, and a valid flag."""
    corners, scores, labels, ncls, thresh, same = case
    B, K = scores.shape
    g = torch.Generator().manual_seed(int(gen.initial_seed()) + B * K)
    return ((torch.randn(B, K, 19, generator=g), torch.from_numpy(corners),
             torch.from_numpy(corners) + 1.0, torch.from_numpy(scores),
             torch.rand(B, K, ncls + 1, generator=g),
             torch.from_numpy(labels),
             torch.rand(B, K, generator=g) < valid_share),
            (ncls, thresh, same))


def _host_keep(case):
    from parq_torch.evals.nms import run_nms
    corners, scores, labels, ncls, thresh, same = case
    return torch.from_numpy(run_nms(
        corners, labels, scores, ncls, thresh,
        "nms_3d_faster_samecls" if same else "nms_3d_faster"))


def _check_nms_kernel(case, gen, plain=True):
    """The kernel's pack on the card: pred_mask = the host library's keep
    mask and valid, bit for bit; the whole pack equal to the plain
    version's (when `plain`); one launch."""
    from parq_torch.kernels.nms import nms_pack
    args, opts = _nms_args(case, gen, valid_share=0.8)
    before = nms_pack.launches
    got = nms_pack(*(t.cuda() for t in args), *opts)
    torch.cuda.synchronize()
    assert nms_pack.launches == before + 1
    keep = _host_keep(case)
    assert torch.equal(got[..., -1].cpu() != 0, keep & args[-1])
    every = nms_pack(*(t.cuda() for t in args[:-1]),
                     torch.ones_like(args[-1]).cuda(), *opts)
    assert torch.equal(every[..., -1].cpu() != 0, keep)
    if plain:
        assert torch.equal(got.cpu(), nms_pack(*args, *opts))
    return keep


@pytest.mark.parametrize("name", torch_common.NMS_EDGE_CASES)
def test_nms_kernel_equals_nms3d_on_edges(gen, name):
    _check_nms_kernel(torch_common.nms_edge_case(name), gen)


@pytest.mark.parametrize("B, K", [(1, 256), (2, 256), (1, 16), (2, 1024)])
def test_nms_kernel_equals_nms3d_and_plain(gen, B, K):
    for same, thresh in ((False, 0.1), (True, 0.2)):
        keep = _check_nms_kernel(torch_common.nms_cluster_case(
            K + B, B, K, thresh, same), gen)
        assert keep.any() and not keep.all()


def test_nms_kernel_on_200_seeds_equals_nms3d_and_nms_mask_device(gen):
    """K = 256, B = 1 on 200 seeds of overlapping clusters with tied
    scores: the keep mask is native.nms3d's bit for bit, and
    nms_mask_device's (f32, its IoU's denominator + 1e-12) wherever no
    pair's f64 IoU lies within 1e-6 of the threshold."""
    from parq_torch.evals import nms_mask_device
    compared = 0
    for seed in range(200):
        case = torch_common.nms_cluster_case(1000 + seed)
        keep = _check_nms_kernel(case, gen, plain=seed < 10)
        corners, scores, labels, ncls, thresh, same = case
        c = torch.from_numpy(corners[0]).cuda()
        lo, hi = c.double().amin(1), c.double().amax(1)
        inter = (torch.minimum(hi[:, None], hi[None])
                 - torch.maximum(lo[:, None], lo[None])).clamp(min=0).prod(-1)
        vol = (hi - lo).prod(-1)
        iou = inter / (vol[:, None] + vol[None] - inter)
        if bool(((iou - thresh).abs() < 1e-6).any()):
            continue
        compared += 1
        dev = nms_mask_device(c, torch.from_numpy(scores[0]).cuda(),
                              torch.from_numpy(labels[0]).cuda(), ncls,
                              thresh, same)
        assert torch.equal(dev.cpu(), keep[0]), seed
    assert compared >= 150


def test_nms_kernel_refuses_more_than_1024_boxes(gen):
    from parq_torch.kernels.nms import nms_pack
    args, opts = _nms_args(torch_common.nms_cluster_case(0, 1, 1025), gen)
    with pytest.raises(ValueError, match="1 to 1024"):
        nms_pack(*(t.cuda() for t in args), *opts)


@pytest.mark.parametrize("for_vis, enable_nms",
                         [(False, True), (True, True), (False, False)])
def test_parse_pred_on_card_is_the_cpu_route(gen, for_vis, enable_nms):
    """parse_pred's device half on the card, then its host half there (one
    copy of the kernel's pack) and on the CPU (the same device arrays,
    copied, and the host library's NMS): the same keys, dtypes and values,
    bit for bit."""
    from parq_torch import telemetry
    from parq_torch.evals import finish_parse_pred, parse_pred_device
    from parq_torch.kernels.nms import nms_pack
    last = _heads(_parse_inputs(gen, K=256))
    Twl = torch.zeros(1, 12, device="cuda")
    Twl[:, [0, 4, 8]] = 1.0
    Twl[:, 9:] = torch.tensor([0.3, -0.2, 0.1])
    telemetry.reset()
    before = nms_pack.launches
    dev = parse_pred_device(last, Twl, (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0),
                            for_vis, 9, enable_nms)
    got = finish_parse_pred(dev)       # the device half's NMS settings
    assert nms_pack.launches == before + 1
    assert telemetry.snapshot()["counters"]["parse_pred.d2h_copies"] == 1
    want = finish_parse_pred({k: v.cpu() for k, v in dev.items()
                              if k not in ("packed", "nms")}, 9, enable_nms,
                             for_vis)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert want["pred_mask"].any() and not want["pred_mask"].all()
    with pytest.raises(ValueError, match="give num_semcls"):
        parse_pred_device(last, Twl, (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0))


def test_device_batch_on_card(gen):
    from parq_torch.data.synthetic import make_batch
    from parq_torch.train.loop import to_device_batch
    host = make_batch([0, 1])
    got = to_device_batch(host, "cuda")
    want = to_device_batch(host, "cpu")
    torch.cuda.synchronize()
    for k, v in want.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k].cpu(), v), k


def test_trainer_fit_and_resume_on_card(gen, tmp_path):
    """The Trainer on the card at a small width the kernels take (head dim
    64, bf16): every step launches B1, B2-train, B3 and B4, each validation
    B1 and B2; a second Trainer resumes with the weights bit for bit."""
    import argparse
    import os
    from parq_torch.cli.train import build_loaders
    from parq_torch.config import get_cfg, update_config
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.train.loop import Trainer
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def cfg_for(epochs):
        cfg = get_cfg()
        update_config(cfg, argparse.Namespace(
            cfg=os.path.join(root, "configs", "smoke.yaml"), opts=[
                "LOG_PATH", str(tmp_path), "TRAINER.PRECISION", "16",
                "TRAINER.MAX_EPOCHS", str(epochs),
                "MODEL.TOKENIZER.OUT_CHANNELS", "256",
                "MODEL.DECODER.TRANSFORMER.DEC_DIM", "256",
                "TPU.FPN_CHANNELS", "64"]))
        return cfg

    cfg = cfg_for(1)
    trainer = Trainer(cfg)
    assert trainer.device.type == "cuda"
    train_loader, val_loader = build_loaders(cfg)
    reset_launch_counts()
    trainer.fit(train_loader, val_loader)
    counts = launch_counts()
    L, steps = int(cfg.MODEL.DECODER.TRANSFORMER.DEC_LAYERS), 2
    assert counts["flash_cross_attention_fwd_train"] == L * steps
    assert counts["flash_cross_attention_bwd"] == steps
    assert counts["pixel_align_bwd_mem"] == steps
    assert counts["flash_cross_attention_fwd"] == L      # one validation
    assert counts["pixel_align_sample"] == L * (steps + 1)
    assert counts["lap_solve"] >= steps + 1     # every step, every val batch
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    cfg2 = cfg_for(2)
    again = Trainer(cfg2)
    loader2, val2 = build_loaders(cfg2)
    again.setup_state(len(loader2))
    assert again.restore_if_available(loader2) and again.global_step == 2
    for k, v in saved.items():
        assert torch.equal(again.model.state_dict()[k], v), k
    again.fit(loader2, val2)
    assert again.global_step == 4


def _lap_costs(gen, P, R, C, n_valid):
    """The matcher's two problem shapes: K <= Q, rows past n_valid flat
    1e4; K > Q (rows = queries), the columns of invalid targets flat."""
    cost = torch.rand((P, R, C), device="cuda", generator=gen) * 3 - 2
    cost = torch.where(torch.arange(R, device="cuda")[None, :, None]
                       < n_valid[:, None, None], cost, 1e4)
    return cost.contiguous()


@pytest.mark.parametrize("P,R,C", [(64, 100, 256), (16, 100, 256),
                                   (5, 7, 7), (3, 20, 300)])
def test_lap_kernel_equals_plain(gen, P, R, C):
    """M1 against its plain version on the same costs: col4row equal bit
    for bit (the same f32 arithmetic, the first index wins a tie)."""
    from parq_torch.kernels.lap import solve_lap, solve_lap_plain
    choices = torch.tensor([0, 1, 3, min(20, R), R], dtype=torch.int32)
    n_rows = choices[torch.arange(P) % 5].to("cuda")
    cost = _lap_costs(gen, P, R, C, n_rows)
    before = solve_lap.launches
    got = solve_lap(cost, n_rows)
    torch.cuda.synchronize()
    assert solve_lap.launches == before + 1
    want = solve_lap_plain(cost.cpu(), n_rows.cpu())
    assert torch.equal(got.cpu(), want)


def test_lap_kernel_on_tied_transposed_problem(gen):
    """The K > Q branch at Q = 64, K = 100: all rows searched, the columns
    of 60 invalid targets flat 1e4 (many exact ties)."""
    from parq_torch.kernels.lap import solve_lap, solve_lap_plain
    P, R, C = 8, 64, 100
    cost = torch.rand((P, R, C), device="cuda", generator=gen)
    cost[:, :, 40:] = 1e4
    cost[:, :, 1] = cost[:, :, 0]
    n_rows = torch.full((P,), R, dtype=torch.int32, device="cuda")
    got = solve_lap(cost.contiguous(), n_rows)
    assert torch.equal(got.cpu(), solve_lap_plain(cost.cpu(), n_rows.cpu()))


def _solve_both(cost, n_rows):
    from parq_torch.kernels.lap import solve_lap, solve_lap_plain
    got = solve_lap(cost.contiguous(), n_rows)
    torch.cuda.synchronize()
    return got.cpu(), solve_lap_plain(cost.cpu(), n_rows.cpu())


@pytest.mark.parametrize("C", [1, 31, 32, 33, 256, 1000])
def test_lap_kernel_at_every_column_count(gen, C):
    """M1 at 1 to 1000 columns (1 to 32 columns a lane in registers; rows
    not a whole number of 16-byte units are read from global memory):
    R = C all searched, n_rows 0, and crowded ties (integer costs, flat
    and duplicated columns); col4row equal to the plain version bit for
    bit."""
    R = C
    cost = torch.rand((3, R, C), device="cuda", generator=gen) * 3 - 2
    ties = torch.randint(0, 3, (R, C), device="cuda", generator=gen).float()
    if C > 3:
        ties[:, C - 3:] = 1e4
        ties[:, 1] = ties[:, 0]
    cost[2] = ties
    n_rows = torch.tensor([R, 0, R], dtype=torch.int32, device="cuda")
    got, want = _solve_both(cost, n_rows)
    assert torch.equal(got, want)
    assert (got[1] == -1).all() and (got[0] >= 0).all()


def test_lap_kernel_past_the_shared_memory_budget(gen):
    """Problems whose rows do not all fit the card's shared memory: the
    first rows are staged, the rest read from global memory in the same
    kernel; 2100 columns keep the lanes' column state in shared memory."""
    from parq_torch.kernels.lap import smem_plan
    budget = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for R, C in ((1000, 1000), (300, 2100)):
        fixed, staged = smem_plan(R, C, budget)
        assert fixed <= budget and staged < R
        cost = torch.rand((2, R, C), device="cuda", generator=gen)
        cost[1, :, ::7] = cost[1, :, :1]            # ties across the rows
        n_rows = torch.tensor([R, R // 2 + 3], dtype=torch.int32,
                              device="cuda")
        got, want = _solve_both(cost, n_rows)
        assert torch.equal(got, want), (R, C)


def test_match_batch_on_the_card_syncs_nothing(gen):
    """`match_batch` at release shapes under sync debug mode "error": no
    device-to-host transfer; its results equal the CPU's."""
    from parq_torch.ops.hungarian import match_batch
    LB, Q, K = 64, 256, 100
    logits = torch.randn((LB, Q, 10), device="cuda", generator=gen)
    coord = torch.rand((LB, Q, 3), device="cuda", generator=gen) * 4 - 2
    center = torch.rand((LB, K, 3), device="cuda", generator=gen) * 4 - 2
    # queries 1-5 copy query 0 (exact ties on either device), near target 0
    coord[:, :6] = center[:, :1] + 0.05
    logits[:, 1:6] = logits[:, :1]
    valid = torch.arange(K, device="cuda")[None] < torch.randint(
        0, 30, (LB, 1), device="cuda", generator=gen)
    labels = torch.where(valid, torch.randint(0, 9, (LB, K), device="cuda",
                                              generator=gen), -1)
    u = torch.rand((LB, Q, K), device="cuda", generator=gen)
    args = (logits, coord, labels, center, valid)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = match_batch(*args, uniforms=u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = match_batch(*(a.cpu() for a in args), uniforms=u.cpu())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _read_back(x):
    return x.sum().item()                      # the one sync, this line


def test_count_syncs_names_the_callers_line(gen):
    """`tools/syncs.count_syncs` counts a read back and names the innermost
    frame under `port` that made it, never its own frame."""
    import inspect
    import os
    from parq_torch.tools.syncs import count_syncs
    x = torch.ones(4, device="cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    n, sites = count_syncs(lambda: _read_back(x), port=here)
    line = inspect.getsourcelines(_read_back)[1] + 1
    assert n == 1 and dict(sites) == {f"tests/test_torch_cuda.py:{line}": 1}
    n, sites = count_syncs(lambda: _read_back(x))
    assert n == 1 and not any("syncs.py" in k for k in sites)


def test_preprocess_device_functions_match_plain(gen):
    """The offline ScanNet preprocessing's three device functions on the
    card against their plain per-frame numpy versions at ScanNet's depth
    size (640x480, 24 rotated boxes, zeros in the depth): depth meters
    equal, points to 1e-12 of the plain ones, counts equal, ratios to
    1e-12."""
    import numpy as np
    from parq_torch.tools.scannet_preprocessing import processing_utils as pu
    rng = np.random.RandomState(0)
    F, H, W, K = 3, 480, 640, 24
    Kd = np.eye(4, dtype=np.float32)
    Kd[0, 0], Kd[1, 1], Kd[0, 2], Kd[1, 2] = 577.87, 577.87, 319.5, 239.5
    Kc = np.eye(4, dtype=np.float32)
    Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2] = 1170.19, 1170.19, 647.75, 483.75
    mm = rng.randint(500, 6000, (F, H, W)) * (rng.rand(F, H, W) > 0.05)
    depth = mm.astype(np.float32) / 1000.0
    corners = np.stack([np.stack([
        pu.make_corners(np.repeat(rng.uniform(0.2, 1.0, 3), 2) * np.tile([-1, 1], 3))
        @ pu.quat_to_matrix(rng.normal(size=4)).T
        + [rng.uniform(-2, 2), rng.uniform(-1.5, 1.5), rng.uniform(1, 5)]
        for _ in range(K)]) for _ in range(F)])
    dev_depth = torch.from_numpy(mm).cuda().float() / torch.full(
        (), 1000.0, device="cuda")
    assert torch.equal(dev_depth.cpu(), torch.from_numpy(depth))
    points, valid = pu.depth_to_points(torch.from_numpy(depth).cuda(), Kd)
    c = torch.from_numpy(corners).cuda()
    counts = pu.points_inside_corners(c, points, valid,
                                      budget_bytes=1 << 28).cpu().numpy()
    ratios = pu.fov_truncation_ratio(c, (968, 1296), Kc).cpu().numpy()
    for f in range(F):
        want = pu.depth_to_point_cloud(depth[f], Kd)
        got = points[f][valid[f]].cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(
            counts[f], pu.points_inside_corners_plain(corners[f], want))
        np.testing.assert_allclose(
            ratios[f], pu.fov_truncation_ratio_plain(corners[f], (968, 1296),
                                                     Kc),
            rtol=1e-12, atol=1e-12)
    assert counts.max() > 1000


def test_preprocess_scene_card_equals_cpu(gen, tmp_path):
    """process_scene on the card writes the records the CPU path writes
    (chip_smoke's synthetic room at 240x320, 30 frames, 24 boxes), with at
    most one sync a chunk."""
    import contextlib
    import io
    import pickle
    import numpy as np
    import chip_smoke
    from parq_torch.tools.scannet_preprocessing import (
        generate_scannet_anno_snippet as pgen, parse_scan2cad)
    from parq_torch.tools.syncs import count_syncs
    scans, jpath = chip_smoke.write_synthetic_scannet(
        str(tmp_path), frames=30, depth_hw=(240, 320))
    anno = str(tmp_path / "anno")
    outs = {}
    with contextlib.redirect_stdout(io.StringIO()):
        parse_scan2cad.generate_anno(jpath, anno)
        for device in ("cuda", "cpu"):
            out = tmp_path / device
            out.mkdir()
            syncs, _ = count_syncs(lambda: pgen.process_scene(
                scans, anno, str(out), "scene0000_00", "overlap", 3,
                device=device, workers=4))
            with open(out / "image_anno_scene0000_00.pkl", "rb") as f:
                outs[device] = (pickle.load(f), syncs)
    (card, syncs), (cpu, _) = outs["cuda"], outs["cpu"]
    assert 0 < syncs <= -(-30 // pgen.CHUNK_FRAMES)
    assert len(card["snippets"]) == len(cpu["snippets"]) > 0
    for a, b in zip(card["snippets"], cpu["snippets"]):
        assert a["image_ids"] == b["image_ids"]
        np.testing.assert_array_equal(a["point_cloud_num_list"],
                                      b["point_cloud_num_list"])
        np.testing.assert_allclose(a["truncation_ratio_list"],
                                   b["truncation_ratio_list"], rtol=1e-12,
                                   atol=1e-12)


# ------------------------------------------------ graphs (jax.jit's twin) --
def _card_tiny(**kw):
    """The tiny model at widths the kernels take (head dim 64)."""
    from parq_torch.config import ModelConfig
    return ModelConfig.tiny(**dict(dict(
        fpn_channels=64, tokenizer_out_channels=256, dec_dim=256,
        num_queries=16), **kw))


@pytest.mark.parametrize("rows,row0,G,M", [(8, 0, 1, 4 * 256 * 256),
                                           (8, 0, 8, 256 * 768),
                                           (3, 5, 2, 77), (2, 4, 3, 16)])
def test_keep_mask_kernel_equals_plain(gen, rows, row0, G, M):
    """The keep-mask kernel against `keep_mask` on the same seeds, bit for
    bit: the vector path (M % 16 == 0) and the scalar one, a strided
    column of the seed table, a rank's first global row."""
    from parq_torch.kernels.dropout import draw_keep, draw_keep_plain
    table = torch.randint(0, 2 ** 62, (G, 6), device="cuda", generator=gen)
    seeds = table[:, 2]
    got = draw_keep(seeds, rows, row0, M, 0.1)
    assert got.shape == (rows, G, M) and got.dtype == torch.bool
    assert torch.equal(got, draw_keep_plain(seeds, rows, row0, M, 0.1))


def test_graphed_forward_replays_the_eager_forward(gen):
    """A replay of the captured eval forward equals the eager forward bit
    for bit, on a second batch too; the serving kernels' counts rise by L
    a replay; nothing synchronizes."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.graphs import Graphed
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import BATCH_KEYS, build_model
    from parq_torch.tools.syncs import count_syncs
    cfg = _card_tiny(compute_dtype="bfloat16")
    model = build_model(cfg, seed=0, device="cuda")
    xs = [to_device(make_batch([i, i + 1], image_size=cfg.image_size),
                    BATCH_KEYS, "cuda") for i in (0, 2)]
    fwd = Graphed(model)
    with torch.inference_mode():
        fwd(xs[0])
        reset_launch_counts()
        n, _ = count_syncs(lambda: fwd(xs[1]))
        assert n == 0 and len(fwd) == 1
        counts = launch_counts()
        assert counts["pixel_align_sample"] == cfg.dec_layers
        assert counts["flash_cross_attention_fwd"] == cfg.dec_layers
        assert counts["frozen_bn"] == _bn_sites(model)
        for x in xs:
            got, want = fwd(x), model(x)
            for k, v in want.items():
                assert torch.equal(got[k], v), k


def _heads_case(gen, B, Q=256, D=1024, classes=9):
    """Four detection heads at width D (`_MLPHeads`) with random weights
    (LeCun normal, GroupNorm scales 1 + N(0, 0.1²), biases N(0, 0.1²)) and
    an f32 decoder-layer output, reference points, mean sizes and the
    release scale box."""
    from parq_torch.models.decoder import _MLPHeads
    heads = _MLPHeads(D, classes).cuda()
    with torch.no_grad():
        for name, p in heads.named_parameters():
            r = torch.randn(p.shape, device="cuda", generator=gen)
            if p.dim() >= 2:
                p.copy_(r / p.shape[1] ** 0.5)
            else:
                norm_scale = name.endswith("weight") and (
                    "layers.1." in name or "layers.5." in name)
                p.copy_(r * 0.1 + (1.0 if norm_scale else 0.0))
    out = torch.randn(B, Q, D, device="cuda", generator=gen)
    ref = torch.rand(B, Q, 3, device="cuda", generator=gen)
    mean_size = torch.rand(classes + 1, 3, device="cuda", generator=gen) + 0.5
    return heads, out, ref, mean_size, (-3.0, 3.0, -2.0, 0.5, 0.25, 5.25)


# kernel against plain (max abs error), and why: the sem_cls logits and
# probabilities are f32 products of the same f32 values, 1,024 terms summed
# in another order; the center, rotation and next reference points pass the
# bf16 trunk, where an f32 sum landing on the other side of a bf16 rounding
# boundary moves one h1 or h2 value by one bf16 ulp (2^-8 of it)
HEADS_ATOL = {"pred_logits": 1e-4, "sem_cls_prob": 1e-5,
              "center_unnormalized": 2e-2, "ortho6d": 2e-2,
              "new_ref": 5e-3}


@pytest.mark.parametrize("B", [1, 8])
def test_heads_kernels_match_plain(gen, B):
    """The heads kernels at release widths (Q=256, D=1024) under bf16
    autocast against their plain version: `HEADS_ATOL`; the argmax class
    equal, and so the size to 1e-4 relative (exp of an f32 product);
    one call counts one launch; a second call gives the same bits."""
    from parq_torch.kernels.heads import (detection_heads,
                                          detection_heads_plain, engages,
                                          head_eps, head_tensors)
    heads, out, ref, mean_size, scale = _heads_case(gen, B)
    with torch.inference_mode(), torch.autocast("cuda",
                                                dtype=torch.bfloat16):
        assert engages(out, ref, heads, 1)
        before = detection_heads.launches
        new_ref, got = detection_heads(out, ref, heads, mean_size, scale)
        torch.cuda.synchronize()
        assert detection_heads.launches == before + 1
        again_ref, again = detection_heads(out, ref, heads, mean_size, scale)
        want = detection_heads_plain(out, ref, head_tensors(heads),
                                     mean_size, scale, head_eps(heads))
    assert torch.equal(again_ref, new_ref)
    for k, v in got.items():
        assert torch.equal(again[k], v), k
    got = dict(got, new_ref=new_ref)
    want = dict(zip(("new_ref", "pred_logits", "center_unnormalized",
                     "size_unnormalized", "ortho6d", "sem_cls_prob"), want))
    errs = {k: float((got[k] - want[k]).abs().max()) for k in HEADS_ATOL}
    print(f"heads B={B}: max abs err {errs}")
    for k, atol in HEADS_ATOL.items():
        assert errs[k] <= atol, (k, errs[k])
    assert torch.equal(got["sem_cls_prob"].argmax(-1),
                       want["sem_cls_prob"].argmax(-1))
    torch.testing.assert_close(got["size_unnormalized"],
                               want["size_unnormalized"], rtol=1e-4, atol=0)


def _heads_cfg(dtype):
    """The card tiny model with 64 queries: widths the heads kernels
    take."""
    return _card_tiny(compute_dtype=dtype, num_queries=64)


def test_graphed_forward_runs_the_heads_kernels(gen, monkeypatch):
    """A bf16 eval forward at widths the heads kernels take: a replay
    equals the eager forward bit for bit and adds one heads call (three
    kernels) an iteration; the forward's outputs against the per-head
    path's on the card within 2% of their norm."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.graphs import Graphed
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import BATCH_KEYS, build_model
    from parq_torch.models import decoder as decoder_mod
    cfg = _heads_cfg("bfloat16")
    model = build_model(cfg, seed=0, device="cuda")
    xs = [to_device(make_batch([i, i + 1], image_size=cfg.image_size),
                    BATCH_KEYS, "cuda") for i in (0, 2)]
    fwd = Graphed(model)
    with torch.inference_mode():
        fwd(xs[0])
        reset_launch_counts()
        got = fwd(xs[1])
        assert launch_counts()["detection_heads"] == cfg.dec_layers
        want = model(xs[1])
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        monkeypatch.setattr(decoder_mod, "heads_engage", lambda *a: False)
        reset_launch_counts()
        plain = model(xs[1])
        assert launch_counts()["detection_heads"] == 0
    gaps = {k: float((v.float() - plain[k].float()).norm()
                     / plain[k].float().norm().clamp(min=1e-12))
            for k, v in want.items() if v.is_floating_point()}
    print(f"heads forward: kernels vs per-head path, relative gaps {gaps}")
    assert max(gaps.values()) <= 0.02, gaps


def test_graphed_bf16_train_step_keeps_the_per_head_path(gen):
    """A captured bf16 train step at widths the heads kernels take runs the
    per-head path and the body's modules: its replay adds no heads call
    and no frozen-BN launch."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import build_model
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import (make_graphed_train_step,
                                             make_optimizer)
    cfg = _heads_cfg("bfloat16")
    model = build_model(cfg, seed=0, device="cuda").train()
    step = make_graphed_train_step(
        model, make_optimizer(model, capturable=True))
    g = torch.Generator(device="cuda")
    b = to_device(make_batch([0, 1], image_size=cfg.image_size), TRAIN_KEYS,
                  "cuda")
    reset_launch_counts()
    step(b, g.manual_seed(1))                     # eager + capture
    step(b, g.manual_seed(2))                     # a replay
    counts = launch_counts()
    assert counts["flash_cross_attention_bwd"] == 2
    assert counts["detection_heads"] == 0
    assert counts["frozen_bn"] == 0


@pytest.mark.parametrize("path", [{}, {"remat": True},
                                  {"share_weights": False}],
                         ids=["fold", "remat", "unshared"])
def test_graphed_train_step_replays_eager_steps(gen, path):
    """f32, TF32 off, dropout 0.1, on the fold, under REMAT and with
    unshared iterations: 2 replays against 2 eager steps, each
    from the same weights, AdamW state (the eager model's, copied in place
    into the captured one) and generator state: losses to 1e-5, every
    clipped gradient within 5e-3·‖g‖ + 1e-6·‖G‖, every updated parameter
    within 5e-3 of its update where Adam's step is well posed (|g| >
    max(2·|Δg|, 1e-6)) and within 2·lr anywhere; a replay makes no sync
    and counts the capture's launches."""
    from parq_torch.data.synthetic import make_batch, to_device
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import build_model
    from parq_torch.tools.syncs import count_syncs
    from parq_torch.train.__main__ import TRAIN_KEYS
    from parq_torch.train.train_step import (make_graphed_train_step,
                                             make_optimizer, train_step)
    cfg = _card_tiny(compute_dtype="float32", dropout_rate=0.1, **path)
    batches = [to_device(make_batch([i, i + 1], image_size=cfg.image_size),
                         TRAIN_KEYS, "cuda") for i in (0, 2)]
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = 1e-3
    folds = not path
    try:
        models = [build_model(cfg, seed=1, device="cuda").train()
                  for _ in range(2)]
        opts = [make_optimizer(m, lr=lr, capturable=True) for m in models]
        gens = [torch.Generator(device="cuda") for _ in range(2)]
        step = make_graphed_train_step(models[0], opts[0])
        step(batches[0], gens[0].manual_seed(5))      # eager + capture
        for i, b in enumerate(batches):
            with torch.no_grad():
                for pg, pe in zip(*(m.parameters() for m in models)):
                    pg.copy_(pe)
                    sg, se = opts[0].state[pg], opts[1].state.get(pe, {})
                    for k, v in sg.items():
                        v.copy_(se[k]) if k in se else v.zero_()
            start = [p.detach().clone() for p in models[1].parameters()]
            want = train_step(models[1], opts[1], b,
                              gens[1].manual_seed(7 + i))
            reset_launch_counts()
            got = []
            n, _ = count_syncs(lambda: got.append(
                step(b, gens[0].manual_seed(7 + i))))
            counts = launch_counts()
            assert n == 0 and len(step) == 1
            L = cfg.dec_layers
            assert counts["flash_cross_attention_bwd"] == (1 if folds else L)
            assert counts["dropout_keep_mask"] == (
                5 * L + 5 if folds else 5 * L * (2 if cfg.remat else 1))
            assert float(got[0]["total_loss"]) == pytest.approx(
                float(want["total_loss"]), rel=1e-5)
            pairs = list(zip(models[0].parameters(),
                             models[1].parameters(), start))
            total = sum(float(pe.grad.norm()) ** 2
                        for _, pe, _ in pairs) ** 0.5
            for pg, pe, s0 in pairs:
                dg = (pg.grad - pe.grad).abs()
                assert float(dg.norm()) <= 5e-3 * float(pe.grad.norm()) \
                    + 1e-6 * total
                posed = pe.grad.abs() > torch.clamp(2 * dg, min=1e-6)
                d = (pg - pe).detach().abs()
                u = (pe - s0).detach()
                assert float((d * posed).norm()) <= \
                    5e-3 * float((u * posed).norm()) + 1e-9
                assert float(d.max()) <= 2 * lr + 1e-6
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def test_capturable_adamw_equals_plain(gen):
    """make_optimizer(capturable=True) on the card: capturable, the lr a
    device tensor that set_lr fills in place; one step equals the plain
    AdamW of make_optimizer (the eager steps') to 1e-6 relative in the
    parameters."""
    from parq_torch.train.train_step import make_optimizer, set_lr
    ps = [torch.randn(s, device="cuda", generator=gen) * 0.03
          for s in ((256, 128), (128,))]
    gs = [torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
          for p in ps]
    mods = []
    for _ in range(2):
        m = torch.nn.ParameterList([torch.nn.Parameter(p.clone())
                                    for p in ps])
        for p, g in zip(m, gs):
            p.grad = g.clone()
        mods.append(m)
    cap = make_optimizer(mods[0], lr=1.0, capturable=True)
    lr = cap.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and cap.defaults["capturable"]
    set_lr(cap, 1e-4)
    assert cap.param_groups[0]["lr"] is lr
    plain = make_optimizer(mods[1], lr=1e-4)
    assert not plain.defaults["capturable"]
    assert not torch.is_tensor(plain.param_groups[0]["lr"])
    cap.step()
    plain.step()
    for a, b in zip(mods[0], mods[1]):
        assert float((a - b).norm() / b.norm()) <= 1e-6


def test_graphed_train_step_refuses_a_plain_optimizer(gen):
    """A captured train step on the card needs make_optimizer(...,
    capturable=True); an eager one (capture=False) takes the plain AdamW."""
    from parq_torch.models import build_model
    from parq_torch.train.train_step import (make_graphed_train_step,
                                             make_optimizer)
    model = build_model(_card_tiny(), seed=0, device="cuda").train()
    with pytest.raises(ValueError, match="capturable"):
        make_graphed_train_step(model, make_optimizer(model))
    make_graphed_train_step(model, make_optimizer(model), capture=False)


def test_graphed_call_keys_each_generator_object(gen):
    """A graph is keyed by the generator object and holds it: a second
    generator with the same seed (a new object) captures its own graph and
    draws what an eager call from that seed draws, and so does every
    later call through either."""
    from parq_torch.graphs import Graphed

    def draw(x, g):
        return x + torch.rand(x.shape, device=x.device, generator=g)
    fn = Graphed(draw)
    x = torch.zeros(1000, device="cuda")

    def eager(seed, n):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [draw(x, g) for _ in range(n)]
    want = eager(3, 3)
    for _ in range(2):        # a fresh generator each time, same seed
        g = torch.Generator(device="cuda").manual_seed(3)
        got = [fn(x, g) for _ in range(3)]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        del g
    assert len(fn) == 2
    assert all(any(isinstance(k, torch.Generator) for k in key[1])
               for key in fn._captures)


def test_device_profile_counts_kernels_not_annotations(gen):
    """A record_function range shows on the device as the span of its
    kernels; the busy time counts the kernels once, not the span again."""
    from parq_torch.tools.profiling import device_profile
    x = torch.randn(1 << 22, device="cuda", generator=gen)

    def run():
        with torch.profiler.record_function("a_span"):
            for _ in range(4):
                x.mul_(1.0)
    prof = device_profile(run)
    names = [k[0] for k in prof["kernels"]]
    assert "a_span" not in names and names
    assert prof["busy_ms"] == pytest.approx(sum(k[1] for k in
                                                prof["kernels"]))


def _parse_inputs(gen, K=64):
    return {"s": torch.rand(1, K, 3, device="cuda", generator=gen),
            "c": torch.randn(1, K, 3, device="cuda", generator=gen),
            "p": torch.randn(1, K, 10, device="cuda", generator=gen),
            "o": torch.randn(1, K, 6, device="cuda", generator=gen)}


def _heads(x):
    """A stand-in forward: a few hundred microseconds of kernels, then the
    last iteration's outputs parse_pred takes."""
    h = x["p"]
    for _ in range(200):
        h = torch.tanh(h * 1.001)
    return {"size_unnormalized": x["s"] + 0.3,
            "center_unnormalized": x["c"] * 0.8,
            "sem_cls_prob": h.softmax(-1), "ortho6d": x["o"] * 1.0}


def test_device_marks_lie_in_order_on_the_host_clock(gen):
    """Graphed replays then parse_pred, as the eval loop runs them: the
    marked batches (two consecutive in every MARK_EVERY) have all their
    marks placed, in order (replay_start ≤ replay_end ≤ decode_end ≤ the
    next replay_start), none before the host time that enqueued it, and
    no decode_end after the end of its batch's copies to the host (each
    within 20 µs); the other batches have none."""
    from parq_torch import telemetry
    from parq_torch.evals import parse_pred
    from parq_torch.graphs import Graphed
    from parq_torch.kernels import reset_launch_counts
    telemetry.reset()
    telemetry.enable(True)
    reset_launch_counts()
    f = Graphed(_heads)
    Twl = torch.zeros(1, 12, device="cuda")
    Twl[:, [0, 4, 8]] = 1.0
    xs = [_parse_inputs(gen) for _ in range(3)]
    for i in range(30):
        parse_pred(f(xs[i % 3]), Twl, (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0), 9)
    torch.cuda.synchronize()
    snap = telemetry.snapshot()
    tol = 20_000
    marks, to_host, replays = {}, {}, []
    for e in snap["ring"]:
        if e["kind"] == "mark":
            assert e["at_ns"] is not None, e
            assert e["at_ns"] >= e["enqueued_ns"] - tol, e
            marks.setdefault(e["batch"], {})[e["name"]] = e["at_ns"]
        elif e["name"] == "parse_pred.to_host":
            to_host[e["batch"]] = e["end_ns"]
        elif e["name"] == "graphs.replay":
            replays.append(e["batch"])
    assert snap["marks"]["placed_before_enqueue"] == 0
    every = telemetry.MARK_EVERY
    full = sorted(b for b, m in marks.items() if len(m) == 3)
    assert len(replays) == 29              # the first call captures
    assert full == [b for b in replays if b % every < 2] and len(full) >= 4
    assert set(marks) <= set(full) | {replays[0] - 1}
    for b in full:
        m = marks[b]
        assert m["replay_start"] <= m["replay_end"] <= m["decode_end"]
        assert m["decode_end"] <= to_host[b] + tol
        if b + 1 in marks:
            assert m["decode_end"] <= marks[b + 1]["replay_start"]
    assert snap["spans"]["graphs.replay"]["count"] == 29
    assert snap["spans"]["graphs.capture"]["count"] == 1
    assert snap["counters"]["parse_pred.d2h_copies"] == 30 * 1
    assert snap["counters"]["kernels.nms.launches"] == 30


def test_nothing_is_recorded_while_a_stream_captures(gen):
    """Spans, counters and marks inside a captured function are not
    recorded (a mark would become a node of the graph); the replay runs
    and records only the graph layer's own."""
    from parq_torch import telemetry
    from parq_torch.graphs import Graphed
    telemetry.reset()
    while telemetry.RECORDER.next_batch() % telemetry.MARK_EVERY != \
            telemetry.MARK_EVERY - 1:
        pass                  # the next two batches (the calls below) mark

    def fn(x):
        with telemetry.span("inside.span"):
            telemetry.count("inside.count")
            telemetry.mark("inside.mark")
            return x * 2
    f = Graphed(fn)
    x = torch.randn(8, device="cuda", generator=gen)
    f(x)                                  # the warm-up records, eagerly
    warm = telemetry.snapshot()
    assert warm["spans"]["inside.span"]["count"] == 1
    assert warm["counters"]["inside.count"] == 1
    assert warm["marks"]["made"] == 1
    assert warm["spans"]["graphs.capture"]["count"] == 1
    for _ in range(3):
        assert torch.equal(f(x), x * 2)
    torch.cuda.synchronize()
    snap = telemetry.snapshot()
    assert snap["spans"]["inside.span"]["count"] == 1
    assert snap["counters"]["inside.count"] == 1
    assert snap["marks"]["made"] == 1 + 2     # the first replay's two
    assert snap["spans"]["graphs.replay"]["count"] == 3


def _dcn_inputs(gen, N, C, H, W, dtype):
    """A map and offsets at PETR's shapes: offsets of a few pixels, the
    first row pushed off the top, the last column off the right, one point
    far off the map, mask logits around 0."""
    x = torch.randn(N, C, H, W, device="cuda", generator=gen).to(dtype)
    om = torch.randn(N, 27, H, W, device="cuda", generator=gen) * 2
    om[:, 0:18:2, 0] -= 4.0
    om[:, 1:18:2, :, -1] += 4.0
    om[0, 0, 1, 1], om[0, 1, 1, 1] = -1e4, 1e4
    cl = torch.channels_last
    return (x.contiguous(memory_format=cl),
            om.to(dtype).contiguous(memory_format=cl))


@pytest.mark.parametrize("shape", [(6, 256, 32, 88), (6, 512, 16, 44)],
                         ids=["stage3", "stage4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_deform_conv_kernel_matches_plain(gen, shape, dtype):
    """The DCNv2 sampling kernel against its plain version at PETR's
    shapes: the kernel's f32 sums differ from grid_sample's by the
    rounding of its normalised coordinates (5e-5); in bf16 the sums are
    rounded once, so the outputs lie within one bf16 ulp of that."""
    from parq_torch.kernels.deform_conv import (deform_columns,
                                                deform_columns_plain)
    x, om = _dcn_inputs(gen, *shape, dtype)
    before = deform_columns.launches
    got = deform_columns(x, om)
    torch.cuda.synchronize()
    assert deform_columns.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[2], shape[3],
                                                9, shape[1])
    sums = deform_columns_plain(x.float(), om.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, sums, rtol=0, atol=5e-5)
    else:
        ulp = sums.abs() * 2 ** -7
        assert bool(((got.float() - sums).abs() <= ulp + 5e-5).all())
    assert torch.count_nonzero(got[0, 1, 1, 0]) == 0     # the far point
    again = deform_columns(x, om)
    assert torch.equal(got, again)                      # no atomics


def test_graphed_petr_replays_the_eager_forward(gen):
    """PETR at its published widths, bf16: a replay equals the eager
    forward bit for bit, and launches the DCN kernel 9 times (one a DCN
    block, the six cameras batched) and the frozen-BN pass 49 times (one
    a BN site of the ResNet-50 body but the downsamples')."""
    from parq_torch.config import PETRConfig
    from parq_torch.graphs import Graphed
    from parq_torch.kernels import launch_counts, reset_launch_counts
    from parq_torch.models import build_petr_model
    cfg = PETRConfig(compute_dtype="bfloat16")
    model = build_petr_model(cfg, seed=0, device="cuda")
    with torch.no_grad():      # offsets of a few pixels, not mmcv's zeros
        for m in model.modules():
            if hasattr(m, "conv_offset"):
                m.conv_offset.weight.normal_(0, 0.05, generator=gen)
    W, H = cfg.image_size
    xs = [{"img": torch.randint(0, 256, (1, 6, 3, H, W), device="cuda",
                                dtype=torch.uint8, generator=gen),
           "lidar2img": torch.eye(4, device="cuda").repeat(1, 6, 1, 1)
           + 0.1 * torch.randn(1, 6, 4, 4, device="cuda", generator=gen)}
          for _ in range(2)]
    fwd = Graphed(model)
    with torch.inference_mode():
        fwd(xs[0])                                     # warm-up + capture
        reset_launch_counts()
        got = [fwd(x) for x in xs]
        assert launch_counts()["deform_conv"] == 2 * 9
        assert launch_counts()["frozen_bn"] == 2 * 49 == 2 * _bn_sites(model)
        for x, g in zip(xs, got):
            want = model(x)
            for k, v in want.items():
                assert torch.isfinite(v).all(), k
                assert torch.equal(g[k], v), k


# ---- the frozen-BN pass of the ResNet body --------------------------------

def _bn_sites(model):
    """The BN sites a forward of `model`'s ResNet body launches the
    frozen-BN pass for: every FrozenBatchNorm2d but the downsamples',
    which ride on their block's last site."""
    from parq_torch.models.resnet_fpn import FrozenBatchNorm2d
    return sum(isinstance(m, FrozenBatchNorm2d)
               and ".downsample." not in f".{n}."
               for n, m in model.named_modules())


def _random_bn(gen, C, eps=1e-5):
    """A FrozenBatchNorm2d off identity: signed scales and shifts, means,
    variances over eight decades."""
    from parq_torch.models.resnet_fpn import FrozenBatchNorm2d
    bn = FrozenBatchNorm2d(C, eps).cuda()
    for b in (bn.weight, bn.bias, bn.running_mean):
        b.copy_(torch.randn(C, device="cuda", generator=gen))
    bn.running_var.copy_(10 ** (8 * torch.rand(C, device="cuda",
                                               generator=gen) - 4))
    return bn


def _bn_map(gen, shape, layout):
    """A bf16 map with NaN, ±Inf, ±0 in it: channels-last, or as the DCN
    returns its output (an (N·H·W, C) matrix viewed NCHW)."""
    N, C, H, W = shape
    x = torch.randn(N, H, W, C, device="cuda", generator=gen) * 3
    x.view(-1)[:5] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf"), 0.0, -0.0])
    x = x.to(torch.bfloat16)
    if layout == "dcn":
        return x.reshape(N * H * W, C).view(N, H, W, C).permute(0, 3, 1, 2)
    return x.permute(0, 3, 1, 2)          # channels-last memory


def _bits16(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("form", ["relu", "identity", "downsample"])
@pytest.mark.parametrize("shape", [(6, 64, 32, 88), (3, 2048, 8, 10),
                                   (2, 72, 7, 9), (1, 8, 1, 3)],
                         ids=["petr_stem_cut", "release_c5", "c72",
                              "one_vector"])
@pytest.mark.parametrize("layout", ["channels_last", "dcn"])
def test_frozen_bn_kernel_matches_the_modules(gen, form, shape, layout):
    """The kernel against the modules' ops on the card (the plain version),
    bit for bit, NaN and infinities included; two launches equal."""
    from parq_torch.kernels.frozen_bn import (engages, frozen_bn_site,
                                              frozen_bn_site_plain)
    C = shape[1]
    x, r = _bn_map(gen, shape, layout), _bn_map(gen, shape, layout)
    bn, bn_d = _random_bn(gen, C), _random_bn(gen, C)
    args = {"relu": (), "identity": (r,), "downsample": (r, bn_d)}[form]
    assert engages(x, *args[:1])
    before = frozen_bn_site.launches
    with torch.inference_mode():
        got = frozen_bn_site(x, bn, *args)
        torch.cuda.synchronize()
        assert frozen_bn_site.launches == before + 1
        want = frozen_bn_site_plain(x, bn, *args)
        again = frozen_bn_site(x, bn, *args)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits16(got), _bits16(want))
    assert torch.equal(_bits16(again), _bits16(got))


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_frozen_bn_scale_and_shift_are_the_modules(gen, eps):
    """s = bf16(w · rsqrt(var + eps)) and t = bf16(bias − mean · inv) as
    the kernel derives them (rsqrtf in its prologue) against the module's
    torch ops, bit for bit, over 2^20 channels whose variances are random
    positive f32 bit patterns (subnormals to 3.4e38): x = 1 with bias and
    mean 0 writes s, x = 0 writes t (w, bias ≥ 0 and mean ≤ 0, so that
    the ReLU passes both)."""
    from parq_torch.kernels.frozen_bn import frozen_bn_site
    C = 1 << 20
    bn = _random_bn(gen, C, eps)
    bn.weight.abs_()
    bn.bias.abs_()
    bn.running_mean.abs_().neg_()
    bits = torch.randint(1, 0x7F800000, (C,), device="cuda", generator=gen,
                         dtype=torch.int32)
    bn.running_var.copy_(bits.view(torch.float32))
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * inv
    one = torch.ones(1, C, 1, 1, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        t = frozen_bn_site(torch.zeros_like(one), bn)
        bn.bias.zero_()
        bn.running_mean.zero_()
        s = frozen_bn_site(one, bn)
    assert torch.equal(_bits16(s.view(C)), _bits16(inv.to(torch.bfloat16)))
    keep = shift.to(torch.bfloat16) != 0       # 0 · s + 0 may be −0
    assert torch.equal(_bits16(t.view(C))[keep],
                       _bits16(shift.to(torch.bfloat16))[keep])


@pytest.mark.parametrize("name,style,dcn", [
    ("resnet50", "pytorch", (False,) * 4),
    ("resnet50", "caffe", (False, False, True, True)),
    ("resnet18", "pytorch", (False,) * 4)],
    ids=["resnet50", "resnet50_caffe_dcn", "resnet18"])
def test_frozen_bn_body_equals_the_modules(gen, monkeypatch, name, style,
                                           dcn):
    """A ResNet body in bf16 (autocast, channels-last, random BN buffers):
    one launch a BN site but the downsamples', the outputs bit for bit
    those of the modules' ops; under grad with trainable weights (a body
    without DCN: the DCN kernel has no backward), no launch."""
    import importlib
    fbn = importlib.import_module("parq_torch.kernels.frozen_bn")
    from parq_torch.models.resnet_fpn import (FrozenBatchNorm2d,
                                              ResNetBody)
    body = ResNetBody(name, style, dcn).cuda()
    for m in body.modules():
        if isinstance(m, FrozenBatchNorm2d):
            rand = _random_bn(gen, m.weight.numel())
            m.load_state_dict(rand.state_dict())
    x = torch.rand(6, 3, 128, 352, device="cuda", generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    auto = torch.autocast("cuda", dtype=torch.bfloat16)
    before = fbn.frozen_bn_site.launches
    with torch.inference_mode(), auto:
        got = body(x)
    assert fbn.frozen_bn_site.launches - before == _bn_sites(body) == (
        49 if name == "resnet50" else 17)
    monkeypatch.setattr(fbn, "engages", lambda *a: False)
    with torch.inference_mode(), auto:
        want = body(x)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(_bits16(g), _bits16(w))
    monkeypatch.undo()
    if not any(dcn):
        before = fbn.frozen_bn_site.launches
        with auto:
            body(x[:1])
        assert fbn.frozen_bn_site.launches == before

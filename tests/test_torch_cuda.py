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
    MAX_SPLITS, _flash_fwd, _flash_fwd_lse, cross_attention_kv_fused_bwd_plain,
    cross_attention_kv_fused_plain, cross_attention_kv_fused_train_plain,
    split_bounds, wgmma_selftest)
from parq_torch.kernels.pixel_align import (sample_views_bwd_mem_plain,
                                            sample_views_plain,
                                            sample_views_sums)

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
    """Every KV split the wrapper may choose at N, and the rule's (None)."""
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
    """B3 in bf16 at D = 256: dq and dKV to 2e-2 of their largest element;
    run twice, the results equal bit for bit (no atomics)."""
    q, kv = _hopper_inputs(gen, Q, N)
    do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    seeds = _seeds(G)
    o, lse = cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    delta = (do.float() * o.float()).sum(-1)
    dq, dkv = flash_bwd(q, kv, do, lse, delta, seeds, rate)
    dq_ref, dkv_ref = cross_attention_kv_fused_bwd_plain(q, kv, do, lse,
                                                         delta, seeds, rate)
    for got, want in ((dq, dq_ref), (dkv, dkv_ref)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=2e-2 * float(want.abs().max()))
    dq2, dkv2 = flash_bwd(q, kv, do, lse, delta, seeds, rate)
    assert torch.equal(dq, dq2) and torch.equal(dkv, dkv2)


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

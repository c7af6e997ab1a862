"""The frozen-BN pass of the ResNet body (`kernels/frozen_bn.py`) on the
CPU: its plain version against the body's compositions as the blocks wrote
them before (bn → relu; bn3 + identity or downsample → add → relu), bit
for bit, in bf16 and f32, with non-identity buffers and NaN/Inf inputs, on
contiguous, channels-last and DCN-permuted maps; the dispatch rule on fake
CUDA tensors (no card here); the blocks and the body through the new call
sites; and no torch._dynamo import on the way. The kernel itself runs on
the card only (tests/test_torch_cuda.py, chip_smoke.py)."""
import contextlib
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from parq_torch.kernels import KERNELS, launch_counts, reset_launch_counts
from parq_torch.kernels.frozen_bn import (engages, frozen_bn_site,
                                          frozen_bn_site_plain)
from parq_torch.models.resnet_fpn import (BasicBlock, Bottleneck,
                                          FrozenBatchNorm2d, ResNetBody)

import torch_common  # noqa: F401

CL = torch.channels_last
LAYOUTS = ("contiguous", "channels_last", "dcn")


def randomize_bns(module: torch.nn.Module, seed: int = 0) -> None:
    """Every FrozenBatchNorm2d of `module` off identity: signed scales and
    shifts, means, variances over four decades."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, FrozenBatchNorm2d):
            C = m.weight.numel()
            m.weight.copy_(torch.randn(C, generator=gen))
            m.bias.copy_(torch.randn(C, generator=gen))
            m.running_mean.copy_(torch.randn(C, generator=gen))
            m.running_var.copy_(10 ** (4 * torch.rand(C, generator=gen) - 2))


def _bn(C, seed):
    bn = FrozenBatchNorm2d(C)
    randomize_bns(bn, seed)
    return bn


def _map(shape, dtype, layout, seed):
    """A map with a NaN, two infinities and a zero in it, laid out as
    `layout`: "dcn" is `modulated_deform_conv`'s output, an (N·H·W, C)
    matrix viewed as (N, C, H, W)."""
    N, C, H, W = shape
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 3
    x.view(-1)[:4] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf"), 0.0])
    x = x.to(dtype)
    if layout == "channels_last":
        return x.contiguous(memory_format=CL)
    if layout == "dcn":
        return x.permute(0, 2, 3, 1).reshape(N * H * W, C).view(
            N, H, W, C).permute(0, 3, 1, 2)
    return x


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("form", ["relu", "identity", "downsample"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plain_equals_the_blocks_compositions(dtype, layout, form):
    shape = (2, 24, 5, 7)
    x = _map(shape, dtype, layout, 1)
    bn, bn_d = _bn(24, 2), _bn(24, 3)
    r = _map(shape, dtype, layout, 4)
    if form == "relu":
        want, args = F.relu(bn(x)), ()
    elif form == "identity":
        want, args = F.relu(bn(x) + r), (r,)
    else:
        want, args = F.relu(bn(x) + bn_d(r)), (r, bn_d)
    assert torch.isnan(want).any()
    reset_launch_counts()
    for got in (frozen_bn_site_plain(x, bn, *args),
                frozen_bn_site(x, bn, *args)):
        assert got.dtype == dtype
        assert torch.equal(_bits(got), _bits(want))
    assert launch_counts()["frozen_bn"] == 0       # the CPU takes plain


# ---- the dispatch rule ----------------------------------------------------

def _fake(shape=(2, 64, 5, 7), dtype=torch.bfloat16, device="cuda",
          layout="channels_last", offset=0):
    """A fake (N, C, H, W) map: channels-last strides, contiguous NCHW, or
    "dcn" (an (N·H·W, C) matrix viewed NCHW); `offset` elements into its
    storage."""
    N, C, H, W = shape
    with FakeTensorMode():
        if layout == "dcn":
            return torch.empty((N * H * W, C), dtype=dtype,
                               device=device).view(N, H, W, C).permute(
                                   0, 3, 1, 2)
        strides = (C * H * W, 1, W * C, C) if layout == "channels_last" \
            else (C * H * W, H * W, W, 1)
        base = torch.empty(N * C * H * W + offset, dtype=dtype,
                           device=device)
        return base.as_strided(shape, strides, offset)


RULE_CASES = {
    "takes": (lambda: (_fake(),), True),
    "takes_identity": (lambda: (_fake(), _fake()), True),
    "takes_dcn_layout": (lambda: (_fake(layout="dcn"), _fake()), True),
    "takes_c_72": (lambda: (_fake((1, 72, 3, 3)),), True),
    "cpu": (lambda: (_fake(device="cpu"),), False),
    "f32": (lambda: (_fake(dtype=torch.float32),), False),
    "nchw_contiguous": (lambda: (_fake(layout="contiguous"),), False),
    "c_not_multiple_of_8": (lambda: (_fake((2, 60, 5, 7)),), False),
    "offset_not_16_bytes": (lambda: (_fake(offset=4),), False),
    "residual_nchw": (lambda: (_fake(), _fake(layout="contiguous")), False),
    "residual_f32": (lambda: (_fake(), _fake(dtype=torch.float32)), False),
    "residual_shape": (lambda: (_fake(), _fake((2, 64, 5, 8))), False),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_dispatch_rule(case):
    make, want = RULE_CASES[case]
    assert engages(*make()) is want


@pytest.mark.parametrize("which", ["input", "residual"])
def test_dispatch_rule_under_grad(which):
    """A map that requires grad is left to the modules' ops under grad
    mode (training records the graph); under no_grad the kernel takes
    it."""
    x, r = _fake(), _fake()
    (x if which == "input" else r).requires_grad_(True)
    assert not engages(x, r)
    with torch.no_grad():
        assert engages(x, r)
    with torch.inference_mode():
        assert engages(x, r)


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "trains"])
def test_the_rule_follows_gradients_not_training(monkeypatch, freeze):
    """A training forward of `ResNetFPN` under grad: a frozen body
    (`BACKBONE2D.FREEZE`) hands every site maps that require no grad, so
    the rule, asked of CUDA twins of those maps, takes all 17 of a
    ResNet-18; a body that trains hands maps that do, and it takes none."""
    import importlib
    from parq_torch.models.resnet_fpn import ResNetFPN
    fbn = importlib.import_module("parq_torch.kernels.frozen_bn")
    rule, verdicts = fbn.engages, []

    def ask_twins(x, residual=None):
        maps = (x,) if residual is None else (x, residual)
        twins = [_fake().requires_grad_(t.requires_grad) for t in maps]
        verdicts.append(rule(*twins))
        return False

    monkeypatch.setattr(fbn, "engages", ask_twins)
    torch.manual_seed(3)
    net = ResNetFPN("resnet18", 16, freeze=freeze).train()
    with torch.enable_grad():
        net(torch.rand(1, 2, 32, 48, 3))
    assert verdicts == [freeze] * 17


def test_dispatch_rule_stands_aside_while_exporting():
    """torch.export traces the modules' ops: the rule refuses while it
    traces, so an exported program carries no call of the kernel."""
    x = _fake()
    assert engages(x)
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, a):
            seen.append(engages(x))
            return a + 1

    with torch.no_grad():
        torch.export.export(Probe(), (torch.ones(2),))
    assert seen == [False]


# ---- the body through the call sites --------------------------------------

def _old_bottleneck(b, x):
    out = F.relu(b.bn1(b.conv1(x)))
    out = F.relu(b.bn2(b.conv2(out)))
    out = b.bn3(b.conv3(out))
    idt = x if b.downsample is None else b.downsample(x)
    return F.relu(out + idt)


def _old_basic(b, x):
    out = F.relu(b.bn1(b.conv1(x)))
    out = b.bn2(b.conv2(out))
    idt = x if b.downsample is None else b.downsample(x)
    return F.relu(out + idt)


def _old_body(body, x):
    x = F.relu(body.bn1(body.conv1(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    feats = []
    for i in range(1, 5):
        for blk in getattr(body, f"layer{i}"):
            x = (_old_bottleneck if isinstance(blk, Bottleneck)
                 else _old_basic)(blk, x)
        feats.append(x)
    return feats


BLOCKS = {
    "bottleneck": lambda: Bottleneck(64, 16),
    "bottleneck_downsample": lambda: Bottleneck(32, 16, 2, True),
    "bottleneck_caffe_dcn": lambda: Bottleneck(64, 16, 2, True, caffe=True,
                                               dcn=True),
    "basic": lambda: BasicBlock(32, 32),
    "basic_downsample": lambda: BasicBlock(16, 32, 2, True),
}


def _compute(dtype):
    """bf16 as the models run it: under autocast, the frozen buffers f32."""
    return torch.autocast("cpu", dtype=torch.bfloat16) \
        if dtype == torch.bfloat16 else contextlib.nullcontext()


DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])


@DTYPES
@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_give_unchanged_outputs(name, dtype):
    torch.manual_seed(0)
    blk = BLOCKS[name]()
    randomize_bns(blk, 7)
    old = _old_bottleneck if isinstance(blk, Bottleneck) else _old_basic
    x = F.relu(torch.randn(2, blk.conv1.in_channels, 9, 11)).to(
        dtype).contiguous(memory_format=CL)
    with torch.no_grad(), _compute(dtype):
        got, want = blk(x), old(blk, x)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


@DTYPES
@pytest.mark.parametrize("name,style,dcn", [
    ("resnet18", "pytorch", (False,) * 4),
    ("resnet50", "pytorch", (False,) * 4),
    ("resnet50", "caffe", (False, False, True, True))],
    ids=["resnet18", "resnet50", "resnet50_caffe_dcn"])
def test_the_body_gives_unchanged_outputs(name, style, dcn, dtype):
    torch.manual_seed(1)
    body = ResNetBody(name, style, dcn)
    randomize_bns(body, 8)
    x = torch.randn(2, 3, 32, 48).contiguous(memory_format=CL)
    reset_launch_counts()
    with torch.no_grad(), _compute(dtype):
        got, want = body(x), _old_body(body, x)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(_bits(g), _bits(w))
    assert launch_counts()["frozen_bn"] == 0
    assert "frozen_bn" in KERNELS


def test_the_body_keeps_its_gradients():
    """Training runs the modules' ops: gradients as the old composition's."""
    torch.manual_seed(2)
    blk = Bottleneck(32, 16, 2, True)
    randomize_bns(blk, 9)
    x = torch.randn(2, 32, 8, 8, requires_grad=True)
    grads = []
    for fwd in (blk, lambda t: _old_bottleneck(blk, t)):
        x.grad = None
        blk.zero_grad()
        fwd(x).square().sum().backward()
        grads.append([x.grad.clone()] + [p.grad.clone()
                                         for p in blk.parameters()])
    for g, w in zip(*grads):
        assert torch.equal(g, w)


def test_petr_and_the_parq_backbone_import_no_dynamo():
    """A fresh process builds and runs PETR and PARQ's backbone on the CPU
    without importing torch._dynamo (its import costs ≈10 s of set-up)."""
    code = textwrap.dedent("""
        import sys, torch
        from parq_torch.config import ModelConfig, PETRConfig
        from parq_torch.models import build_model, build_petr_model
        cfg = PETRConfig.tiny()
        petr = build_petr_model(cfg, seed=0, device="cpu").eval()
        W, H = cfg.image_size
        x = {"img": torch.randint(0, 256, (1, cfg.num_cams, 3, H, W),
                                  dtype=torch.uint8),
             "lidar2img": torch.eye(4).repeat(1, cfg.num_cams, 1, 1)}
        mc = ModelConfig.tiny()
        parq = build_model(mc, seed=0, device="cpu").eval()
        W, H = mc.image_size
        with torch.inference_mode():
            petr(x)
            parq.backbone2d(torch.rand(1, mc.num_views, H, W, 3))
        sys.exit(3 if "torch._dynamo" in sys.modules else 0)
    """)
    done = subprocess.run([sys.executable, "-c", code], timeout=300,
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-2000:]

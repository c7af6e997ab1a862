"""The detection heads' plain version and dispatch rule, on the CPU.

- `detection_heads_plain` (the plain version of the kernels of
  csrc/heads.cu) equals the per-head path (the four HeadMLPs and the
  decoder's decode) bit for bit in a bf16 forward, on every iteration's
  heads, at B=1 and B=2, with shared and unshared weights; so does the
  custom op ``parq::detection_heads`` on CPU tensors, and the decoder's
  outputs when it takes the call through the custom op.
- `engages` sends the training path (grad mode), the f32 dtype (no bf16
  autocast), the fold's groups, the CPU and widths the kernels do not take
  to the per-head path, and the fold's trajectory pass (refs_only, the
  center head alone) never reaches it.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from parq_torch.config import ModelConfig
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.geometry import normalize_points
from parq_torch.kernels import heads as hk
from parq_torch.models import BATCH_KEYS, build_model
from parq_torch.models import decoder as decoder_mod
from parq_torch.models.decoder import DecoderLayer, _MLPHeads
from parq_torch.train.__main__ import TRAIN_KEYS

import torch_common  # noqa: F401


def _model(share):
    cfg = ModelConfig.tiny(compute_dtype="bfloat16", share_weights=share)
    return build_model(cfg, seed=3, device="cpu")


def _run(model, B, keys=BATCH_KEYS, **kw):
    """The model's outputs, and each iteration's decoder-layer output in
    call order."""
    x = to_device(make_batch(list(range(B)),
                             image_size=model.cfg.image_size), keys, "cpu")
    outs = []
    hooks = [m.register_forward_hook(lambda m, a, o: outs.append(o))
             for m in model.modules() if isinstance(m, DecoderLayer)]
    try:
        with torch.no_grad():
            y = model(x, **kw)
    finally:
        for h in hooks:
            h.remove()
    return y, outs


@pytest.mark.parametrize("share", [True, False], ids=["shared", "unshared"])
@pytest.mark.parametrize("B", [1, 2])
def test_plain_equals_the_per_head_path(B, share):
    model = _model(share)
    dec = model.box3d_decoder
    y, outs = _run(model, B)
    L = dec.num_layers
    assert len(outs) == L
    ref = torch.sigmoid(dec.refpoint.weight)[None].expand(B, -1, 3)
    for l in range(L):
        heads = dec.iteration_modules(l)[2]
        args = (outs[l], ref, hk.head_tensors(heads), dec.mean_size,
                dec.scale, hk.head_eps(heads))
        got = hk.detection_heads_plain(*args)
        new_ref = normalize_points(y["center_unnormalized"][l], dec.scale)
        assert torch.equal(got[0], new_ref)
        for k, v in zip(hk.OUTPUT_KEYS, got[1:]):
            assert v.dtype == torch.float32
            assert torch.equal(v, y[k][l]), (l, k)
        before = hk.detection_heads.launches
        op_ref, op = hk.detection_heads(outs[l], ref, heads, dec.mean_size,
                                        dec.scale)
        assert hk.detection_heads.launches == before   # CPU: no kernel
        assert torch.equal(op_ref, new_ref)
        assert list(op) == list(hk.OUTPUT_KEYS)
        for k in hk.OUTPUT_KEYS:
            assert torch.equal(op[k], y[k][l]), (l, k)
        ref = new_ref


@pytest.mark.parametrize("share", [True, False], ids=["shared", "unshared"])
def test_decoder_through_the_custom_op_equals_the_per_head_path(
        monkeypatch, share):
    """With the dispatch rule forced on, the decoder takes the custom op
    (its CPU version) in every iteration and its outputs, keys in order,
    equal the per-head path's."""
    model = _model(share)
    want, _ = _run(model, 2)
    calls = []
    real = decoder_mod.detection_heads

    def counted(*a):
        calls.append(a[2])
        return real(*a)

    monkeypatch.setattr(decoder_mod, "heads_engage", lambda *a: True)
    monkeypatch.setattr(decoder_mod, "detection_heads", counted)
    got, _ = _run(model, 2)
    dec = model.box3d_decoder
    assert calls == [dec.iteration_modules(l)[2]
                     for l in range(dec.num_layers)]
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_fold_trajectory_pass_keeps_the_per_head_path(monkeypatch):
    """A training forward runs the fold: its trajectory pass (refs_only,
    one group) must not reach the heads kernels even where the rest of the
    rule holds, and its folded call has L groups."""
    model = _model(True).train()
    seen = []

    def rule(out, ref, heads, n_groups):
        seen.append(n_groups)
        return n_groups == 1

    def refuse(*a):
        raise AssertionError("the heads kernels took a fold call")

    monkeypatch.setattr(decoder_mod, "heads_engage", rule)
    monkeypatch.setattr(decoder_mod, "detection_heads", refuse)
    _run(model, 2, TRAIN_KEYS, deterministic=False,
         generator=torch.Generator().manual_seed(0))
    assert seen == [model.box3d_decoder.num_layers]


def _fake_case(Q=64, D=64, classes=9, B=2):
    heads = _MLPHeads(D, classes)
    with FakeTensorMode():
        out = torch.empty((B, Q, D), device="cuda")
        ref = torch.empty((B, Q, 3), device="cuda")
    return out, ref, heads


@pytest.mark.parametrize("case", [
    "takes", "grad", "f32", "groups", "cpu", "bf16_input", "q_not_64",
    "d_not_64", "d_over_1024", "classes_over_32", "center_widths"])
def test_dispatch_rule(monkeypatch, case):
    """`engages` on fake CUDA tensors (no card here), with bf16 autocast
    stood in for by the rule's own probe; one condition broken a case."""
    autocast = case != "f32"
    monkeypatch.setattr(hk, "autocast_bf16", lambda: autocast)
    kw = dict(Q={"q_not_64": 72}.get(case, 64),
              D={"d_not_64": 96, "d_over_1024": 1088}.get(case, 64),
              classes=40 if case == "classes_over_32" else 9)
    out, ref, heads = _fake_case(**kw)
    if case == "center_widths":
        heads.center_head = decoder_mod.HeadMLP(kw["D"], (kw["D"],), 3)
    if case == "cpu":
        out, ref = torch.zeros(2, 64, 64), torch.zeros(2, 64, 3)
    if case == "bf16_input":
        with FakeTensorMode():
            out = torch.empty((2, 64, 64), device="cuda",
                              dtype=torch.bfloat16)
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    with grad:
        got = hk.engages(out, ref, heads, 3 if case == "groups" else 1)
    assert got is (case == "takes")


def test_dispatch_rule_reads_cuda_autocast():
    """The probe is CUDA bf16 autocast: off outside it, and CPU autocast
    does not count."""
    assert not hk.autocast_bf16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert not hk.autocast_bf16()
    out, ref, heads = _fake_case()
    with torch.no_grad():
        assert not hk.engages(out, ref, heads, 1)

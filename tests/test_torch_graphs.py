"""The port's counterpart of jax.jit (parq_torch/graphs.py) and what a
captured step needs, on the CPU at a tiny width:

- a train step with dropout 0.1 reads nothing back to the host: it runs
  with `Tensor.tolist`, `.item`, `__int__`, `__float__` and `__bool__`
  patched to raise. Two plain versions read on the CPU and are let through:
  the matcher's LAP (a loop with host control flow), whose card twin is
  kernel M1, and the CPU's AdamW (its step count is a host number), whose
  card twin is the capturable AdamW; both read nothing back on the card;
- the decoder's flash seeds, now computed on the device, equal the host
  formula they replaced bit for bit on the same generator state;
- the keep masks: the fold's draws equal the sequential path's, a
  data-parallel rank's rows equal those rows of the one-process mask, the
  keep rate lies within 5σ of 1 − rate, and the bits are the v1 counter
  hash of csrc/dropout.cu (an independent numpy version);
- the constants built once per device equal the values built per call;
- on the CPU the graphed steps equal `train_step` / `eval_step` bit for
  bit (a graph is captured only for CUDA tensors; the card's tests and
  chip_smoke.py's `[graphs]` phase hold the replays).
"""
import contextlib
import importlib
import math

import numpy as np
import pytest
import torch

from parq_torch.config import ModelConfig
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.graphs import Graphed, _flatten, _signature, _unflatten
from parq_torch.kernels.dropout import draw_keep, draw_keep_plain
from parq_torch.models import build_model
from parq_torch.models.decoder import (N_SALTS, SALT_CA_W, SALT_DROP1,
                                       SALT_FFN, SALT_SA_W, DropoutDraws)
from parq_torch.train.__main__ import TRAIN_KEYS
from parq_torch.train.train_step import (eval_step, make_graphed_eval_step,
                                         make_graphed_train_step,
                                         make_optimizer, set_lr, train_step)

import torch_common  # noqa: F401

RATE = 0.1


def _tiny(rate=RATE, **kw):
    return ModelConfig.tiny(dropout_rate=rate, compute_dtype="float32", **kw)


def _batch(cfg, B=2, first=0):
    return to_device(make_batch(list(range(first, first + B)),
                                image_size=cfg.image_size), TRAIN_KEYS,
                     "cpu")


_READS = ("tolist", "item", "__int__", "__float__", "__bool__")
_ORIGINAL = {n: getattr(torch.Tensor, n) for n in _READS}


def _refuse(*a, **k):
    raise AssertionError("a host read in the step")


@contextlib.contextmanager
def _host_reads(allowed: bool):
    """Every Python-level read of a tensor's value raises (`allowed`
    False), or works again inside such a block (True)."""
    before = {n: getattr(torch.Tensor, n) for n in _READS}
    for n in _READS:
        setattr(torch.Tensor, n, _ORIGINAL[n] if allowed else _refuse)
    try:
        yield
    finally:
        for n, f in before.items():
            setattr(torch.Tensor, n, f)


def test_train_step_reads_nothing_back(monkeypatch):
    from parq_torch.ops import hungarian
    solve = hungarian.solve_lap

    def allowed(fn):
        def run(*a, **k):
            with _host_reads(allowed=True):
                return fn(*a, **k)
        return run
    monkeypatch.setattr(hungarian, "solve_lap", allowed(solve))
    cfg = _tiny()
    model = build_model(cfg, seed=0, device="cpu").train()
    opt = make_optimizer(model)
    monkeypatch.setattr(opt, "step", allowed(opt.step))
    batch = _batch(cfg)
    gen = torch.Generator().manual_seed(1)
    with _host_reads(allowed=False):
        metrics = train_step(model, opt, batch, gen)
    assert math.isfinite(float(metrics["total_loss"]))


@pytest.mark.parametrize("groups", [(0,), (3,), (0, 1, 2, 3), (2, 0)])
def test_flash_seeds_equal_the_host_formula(groups):
    L = 4
    host = torch.randint(0, 2 ** 62, (L, N_SALTS),
                         generator=torch.Generator().manual_seed(5)).tolist()
    want = [host[l][SALT_CA_W] % (2 ** 31 - 1) for l in groups]
    drops = DropoutDraws(RATE, L, "cpu", torch.Generator().manual_seed(5))
    got = drops.flash_seeds(groups)
    assert torch.is_tensor(got) and got.dtype == torch.int32
    assert got.tolist() == want
    assert torch.equal(drops.seeds, torch.tensor(host))


@pytest.mark.parametrize("salt,inner", [(SALT_SA_W, (1, 4, 6, 6)),
                                        (SALT_DROP1, (6, 32)),
                                        (SALT_FFN, (6, 48))])
def test_fold_draws_what_the_sequential_path_draws(salt, inner):
    L, B = 4, 3
    drops = DropoutDraws(RATE, L, "cpu", torch.Generator().manual_seed(2))
    folded = drops.keep(tuple(range(L)), salt, (B,) + inner)
    seq = torch.cat([drops.keep((l,), salt, (B,) + inner)
                     for l in range(L)], dim=1)
    assert folded.shape == (B, L * inner[0]) + inner[1:]
    assert torch.equal(folded, seq)
    # and the sequential draws of two iterations differ
    assert not torch.equal(drops.keep((0,), salt, (B,) + inner),
                           drops.keep((1,), salt, (B,) + inner))


@pytest.mark.parametrize("b_offset,rows", [(0, 2), (2, 2), (3, 1)])
def test_data_rank_draws_its_rows_of_the_global_mask(b_offset, rows):
    L, Q, C = 3, 5, 16
    seeds = torch.Generator().manual_seed(9)
    one = DropoutDraws(RATE, L, "cpu", seeds)
    rank = DropoutDraws(RATE, L, "cpu", torch.Generator().manual_seed(9),
                        b_offset=b_offset)
    for groups in ((1,), tuple(range(L))):
        whole = one.keep(groups, SALT_DROP1, (4, Q, C))
        part = rank.keep(groups, SALT_DROP1, (rows, Q, C))
        assert torch.equal(part, whole[b_offset:b_offset + rows])
        assert torch.equal(rank.flash_seeds(groups), one.flash_seeds(groups))


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_rate_within_five_sigma(rate):
    drops = DropoutDraws(rate, 2, "cpu", torch.Generator().manual_seed(4))
    keep = drops.keep((0, 1), SALT_FFN, (8, 64, 96))
    n = keep.numel()
    p = 1.0 - rate
    assert abs(float(keep.float().mean()) - p) <= 5 * math.sqrt(
        p * (1 - p) / n)


def _fmix_v1(seed, rows, cols, thresh):
    """csrc/dropout.cu's hash in numpy uint32 arithmetic."""
    with np.errstate(over="ignore"):
        r = np.asarray(rows, np.uint32)[:, None]
        c = np.arange(cols, dtype=np.uint32)[None, :]
        h = (np.uint32(seed & 0xFFFFFFFF) * np.uint32(2654435761)
             + r * np.uint32(3266489917) + c * np.uint32(668265263))
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h >= np.uint32(thresh)


def test_keep_mask_bits_are_the_v1_counter_hash():
    seeds = torch.tensor([3, 2 ** 40 + 17, 2 ** 62 - 1], dtype=torch.int64)
    rows, row0, cols = 3, 5, 77
    got = draw_keep(seeds, rows, row0, cols, RATE)
    assert got.shape == (rows, 3, cols) and got.dtype == torch.bool
    thresh = min(int(RATE * 2 ** 32), 2 ** 32 - 1)
    for g, s in enumerate(seeds.tolist()):
        want = _fmix_v1(s, range(row0, row0 + rows), cols, thresh)
        assert np.array_equal(got[:, g].numpy(), want)
    # a strided column of the seed table takes the same path
    table = torch.stack([seeds, seeds + 1], dim=1)
    assert torch.equal(draw_keep(table[:, 0], rows, row0, cols, RATE), got)
    assert torch.equal(draw_keep_plain(seeds, rows, row0, cols, RATE), got)


def test_constants_built_once_equal_the_per_call_values():
    from parq_torch.geometry import roty
    from parq_torch.geometry.obb import _CORNER_SIGNS, corner_signs
    sl = importlib.import_module("parq_torch.losses.set_loss")
    from parq_torch.models.ray_pe import AddRayPE
    signs = corner_signs(torch.float32, "cpu")
    assert torch.equal(signs, torch.as_tensor(_CORNER_SIGNS))
    assert corner_signs(torch.float32, "cpu") is signs
    Rk, valid = sl._sym_tables("cpu")
    assert torch.equal(Rk, roty(torch.as_tensor(sl._ANGLES)).reshape(144, 9))
    assert torch.equal(valid, torch.as_tensor(sl._VALID).reshape(-1))
    n, bg = 9, 0.1
    old = torch.ones(n + 1)
    old[n] = bg
    assert torch.equal(sl.class_weights(n, bg, "cpu"), old)
    pe = AddRayPE(32, num_samples=4)
    s = pe.ray_points_scale
    assert torch.equal(pe.box_lo, torch.tensor([s[0], s[2], s[4]]))
    assert torch.equal(pe.box_span, torch.tensor(
        [s[1] - s[0], s[3] - s[2], s[5] - s[4]]))
    assert "box_lo" not in pe.state_dict()


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("kw", [{}, {"remat": True},
                                {"share_weights": False}])
def test_graphed_train_step_equals_train_step_on_cpu(kw):
    cfg = _tiny(**kw)
    batches = [_batch(cfg, first=0), _batch(cfg, first=2)]
    runs = []
    for graphed in (False, True):
        model = build_model(cfg, seed=3, device="cpu").train()
        opt = make_optimizer(model, lr=1e-3)
        gen = torch.Generator().manual_seed(11)
        step = make_graphed_train_step(model, opt) if graphed else None
        metrics = []
        for i in range(2):
            set_lr(opt, 1e-3 / (i + 1))
            m = (step(batches[i], gen) if graphed
                 else train_step(model, opt, batches[i], gen))
            metrics.append({k: v.clone() for k, v in m.items()})
        assert step is None or len(step) == 0     # nothing captured here
        runs.append((metrics, _params(model)))
    (m0, p0), (m1, p1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_graphed_train_step_accumulates_as_train_step_on_cpu():
    cfg = _tiny()
    batches = [_batch(cfg, first=0), _batch(cfg, first=2)]
    out = []
    for graphed in (False, True):
        model = build_model(cfg, seed=4, device="cpu").train()
        opt = make_optimizer(model)
        gen = torch.Generator().manual_seed(1)
        step = make_graphed_train_step(model, opt)
        for i in range(2):
            if graphed:
                step(batches[i], gen, accumulate=2, micro_step=i)
            else:
                train_step(model, opt, batches[i], gen, accumulate=2,
                           micro_step=i)
        out.append(_params(model))
    for n in out[0]:
        assert torch.equal(out[0][n], out[1][n]), n


def test_graphed_eval_step_equals_eval_step_on_cpu():
    cfg = _tiny()
    model = build_model(cfg, seed=5, device="cpu")
    batch = _batch(cfg)
    want_l, want_o = eval_step(model, batch, torch.Generator().manual_seed(0))
    step = make_graphed_eval_step(model)
    got_l, got_o = step(batch, torch.Generator().manual_seed(0))
    assert len(step) == 0
    for k in want_l:
        assert torch.equal(got_l[k], want_l[k]), k
    for k in want_o:
        assert torch.equal(got_o[k], want_o[k]), k


def test_set_lr_fills_a_tensor_lr_in_place():
    model = torch.nn.Linear(3, 2)
    opt = make_optimizer(model, lr=1e-3)
    assert opt.param_groups[0]["lr"] == 1e-3        # a float on the CPU
    set_lr(opt, 2e-3)
    assert opt.param_groups[0]["lr"] == 2e-3
    lr = torch.tensor(1e-3)
    opt.param_groups[0]["lr"] = lr
    set_lr(opt, 5e-4)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(
        5e-4)


def test_make_optimizer_is_plain_unless_captured():
    """The plain AdamW (lr a float) by default and always on the CPU: a
    capturable one is asked for by the steps that are captured on the
    card."""
    model = torch.nn.Linear(3, 2)
    for kw in ({}, {"capturable": True}):
        opt = make_optimizer(model, lr=1e-3, **kw)
        assert not opt.defaults["capturable"]
        assert opt.param_groups[0]["lr"] == 1e-3
    make_graphed_train_step(model, make_optimizer(model))   # CPU: eager


def test_a_graph_key_holds_its_generator():
    gen = torch.Generator()
    assert _signature(gen) is gen
    assert _signature(torch.zeros(2, 3)) == ("tensor", (2, 3),
                                             torch.float32,
                                             torch.device("cpu"))


def test_graphed_runs_cpu_tensors_eagerly():
    calls = []

    def fn(batch, scale):
        calls.append(scale)
        return {"y": batch["x"] * scale}, [batch["x"].sum()]
    g = Graphed(fn)
    x = torch.arange(4.0)
    out, (s,) = g({"x": x}, 3.0)
    assert torch.equal(out["y"], x * 3.0) and float(s) == 6.0
    assert calls == [3.0] and len(g) == 0


def test_flatten_round_trips_a_batch_and_its_statics():
    gen = torch.Generator()
    tree = ({"a": torch.zeros(2), "b": [torch.ones(1), 3]}, gen, None, 0.5)
    leaves = []
    spec = _flatten(tree, leaves)
    assert hash(spec) is not None and len(leaves) == 6
    back = _unflatten(spec, iter(leaves))
    assert back[1] is gen and back[2] is None and back[3] == 0.5
    assert back[0]["b"][1] == 3 and torch.equal(back[0]["a"], tree[0]["a"])

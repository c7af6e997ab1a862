"""The port's trainer and checkpoints (parq_torch/train/{loop,checkpoint}.py)
on configs/smoke.yaml with TPU.PLATFORM cpu, against the port's own step
and the JAX package where it has the same function:

- checkpoints: a save/restore round trip is bit-equal (weights, AdamW
  moments, step, data_state); top-k plus last retention keeps the right
  files; a strict load with a missing or extra key raises; a
  reference-layout state_dict with the dead `decoder.norm.*` loads
  strictly; a torchvision ResNet state_dict warm-starts the backbone only,
  and the same tensors through JAX's `convert_torchvision_resnet` give the
  same forward (2e-4);
- Trainer.fit (2 epochs of 2 steps at B=2, warm-up 1 epoch, a
  torch.profiler trace of step 3): the per-step losses equal, bit for bit,
  a loop of `train_step` with the same batches, generator and LR; the LR
  at each step equals JAX's `build_lr_schedule` to 1e-7 relative (JAX
  computes it in float32, one rounding of which is up to 6e-8 relative;
  the port in double);
- ACCUMULATE_GRAD_BATCHES 2 equals one step on the mean gradient;
- LIMIT_VAL_BATCHES follows Lightning's table (tests/test_trainer_loop.py);
- a resume continues at the saved step with equal weights.
"""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.config import get_cfg as j_get_cfg
from parq_tpu.config import update_config as j_update_config
from parq_tpu.io.torch_convert import (convert_parq_checkpoint,
                                       convert_torchvision_resnet)
from parq_tpu.models import PARQModel as JPARQModel
from parq_tpu.train.checkpoint import _merge
from parq_tpu.train.schedule import build_lr_schedule as j_build_lr

from parq_torch.cli.train import build_loaders
from parq_torch.config import ModelConfig, get_cfg, update_config
from parq_torch.data import SnippetLoader, SyntheticDataset
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.models import BATCH_KEYS, build_model
from parq_torch.train.checkpoint import (DEAD_PREFIX, CheckpointManager,
                                         load_pretrained)
from parq_torch.train.loop import (DEVICE_KEYS, Trainer, to_device_batch,
                                   val_batch_limit)
from parq_torch.train.schedule import lr_schedule_from_cfg
from parq_torch.train.train_step import (clip_by_global_norm_,
                                         forward_and_loss, make_optimizer,
                                         train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "smoke.yaml")


def smoke_cfg(tmp_path, *opts, jax_too=False):
    args = argparse.Namespace(cfg=SMOKE, opts=[
        "TPU.PLATFORM", "cpu", "LOG_PATH", str(tmp_path), *opts])
    cfg = get_cfg()
    update_config(cfg, args)
    if not jax_too:
        return cfg
    jcfg = j_get_cfg()
    j_update_config(jcfg, args)
    return cfg, jcfg


def read_metrics(trainer, stage="train"):
    with open(trainer.metrics_path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["stage"] == stage]


# ------------------------------------------------------------ checkpoints --
def trained_trainer(tmp_path, steps=2):
    cfg = smoke_cfg(tmp_path)
    trainer = Trainer(cfg)
    trainer.setup_state(steps_per_epoch=2)
    batch = to_device_batch(make_batch([0, 1]), "cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        train_step(trainer.model, trainer.optimizer, batch, gen,
                   trainer.loss_cfg)
    return cfg, trainer


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    cfg, trainer = trained_trainer(tmp_path)
    data_state = {"epoch": 3, "position": 1, "seed": 100}
    trainer.ckpt_mgr.save(7, trainer.model, trainer.optimizer,
                          metrics={"0.5_f1": 0.25}, data_state=data_state)
    fresh = Trainer(cfg)
    fresh.setup_state(steps_per_epoch=2)
    loader = SnippetLoader(SyntheticDataset(4), 2)
    assert fresh.restore_if_available(loader)
    assert fresh.global_step == 7
    assert loader.state_dict() == data_state
    for (n, a), b in zip(trainer.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    want, got = (o.state_dict()["state"] for o in
                 (trainer.optimizer, fresh.optimizer))
    assert sorted(want) == sorted(got) and want
    for i in want:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(want[i][k], got[i][k]), (i, k)


@pytest.mark.parametrize("top_k, last, mode, kept, best", [
    (2, True, "max", {2, 3, 5}, 2),
    (2, False, "max", {2, 3}, 2),
    (1, True, "min", {5}, 5),
    (0, True, "max", {5}, 2),
    (-1, False, "max", {1, 2, 3, 4, 5}, 2),
])
def test_retention_keeps_top_k_and_last(tmp_path, top_k, last, mode, kept,
                                        best):
    model = torch.nn.Linear(2, 2)
    mgr = CheckpointManager(str(tmp_path), save_top_k=top_k, save_last=last,
                            mode=mode)
    for step, f1 in zip(range(1, 6), (0.1, 0.5, 0.3, 0.2, 0.05)):
        mgr.save(step, model, metrics={"0.5_f1": f1, "total_loss": 1.0})
    assert set(mgr.steps()) == kept
    files = {f for f in os.listdir(tmp_path) if f.endswith(".pt")}
    assert files == {f"step_{s}.pt" for s in kept}
    if top_k:
        assert mgr.best_step() == (best if mode == "max" else 5)
    again = CheckpointManager(str(tmp_path), save_top_k=top_k,
                              save_last=last, mode=mode)
    assert again.steps() == mgr.steps()


def test_strict_load_rejects_missing_and_extra_keys(tmp_path):
    model = build_model(ModelConfig.tiny(), seed=0, device="cpu")
    sd = model.state_dict()
    name = "box3d_decoder.refpoint.weight"
    missing = {k: v for k, v in sd.items() if k != name}
    extra = dict(sd, **{"box3d_decoder.no_such.weight": torch.zeros(1)})
    for bad, word in ((missing, "missing"), (extra, "unexpected")):
        path = str(tmp_path / f"{word}.pt")
        torch.save(bad, path)
        with pytest.raises(ValueError, match=word):
            load_pretrained(model, path, strict=True)
        load_pretrained(model, path, strict=False)


def test_reference_layout_with_dead_norm_loads_strictly(tmp_path):
    src = build_model(ModelConfig.tiny(), seed=1, device="cpu")
    sd = dict(src.state_dict())
    D = src.cfg.dec_dim
    sd[DEAD_PREFIX + "weight"] = torch.ones(D)
    sd[DEAD_PREFIX + "bias"] = torch.zeros(D)
    path = str(tmp_path / "release_layout.ckpt")
    torch.save({"state_dict": sd}, path)
    dst = build_model(ModelConfig.tiny(), seed=2, device="cpu")
    load_pretrained(dst, path, strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_torchvision_warm_start_equals_jax(tmp_path):
    """A torchvision-layout ResNet state_dict (body keys without prefix, fc,
    BN num_batches_tracked) made from a tiny backbone: the warm start
    replaces the body only; through JAX's convert_torchvision_resnet the
    same tensors give the same forward."""
    cfg, jcfg = smoke_cfg(tmp_path, jax_too=True)
    mcfg = ModelConfig.from_cfg(cfg)
    donor = build_model(mcfg, seed=5, device="cpu")
    body = "backbone2d.resnet_fpn.body."
    tv = {k[len(body):]: v.clone() for k, v in donor.state_dict().items()
          if k.startswith(body)}
    with torch.no_grad():
        for k, v in tv.items():
            if k.endswith("running_var"):
                v.uniform_(0.5, 1.5)
    tv["fc.weight"], tv["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    tv["bn1.num_batches_tracked"] = torch.tensor(3)
    path = str(tmp_path / "resnet18.pth")
    torch.save(tv, path)

    port = build_model(mcfg, seed=6, device="cpu")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match="strict"):
        load_pretrained(port, path, strict=True)
    load_pretrained(port, path, strict=False)
    for k, v in port.state_dict().items():
        if k.startswith(body):
            assert torch.equal(v, tv[k[len(body):]]), k
        else:
            assert torch.equal(v, before[k]), k

    jmodel = JPARQModel.from_config(jcfg)
    base = convert_parq_checkpoint(
        {k: v.numpy() for k, v in before.items()}, num_heads=4)
    warm = convert_torchvision_resnet({k: v.numpy() for k, v in tv.items()})
    variables = {"params": _merge(base["params"], warm["params"]),
                 "frozen": _merge(base["frozen"], warm["frozen"])}
    batch = make_batch([0, 1], image_size=mcfg.image_size)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True))(
        variables, {k: jnp.asarray(batch[k]) for k in BATCH_KEYS})
    with torch.no_grad():
        got = port(to_device(batch, BATCH_KEYS, "cpu"))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, rtol=2e-4, err_msg=k)


# ---------------------------------------------------------------- trainer --
def test_fit_equals_train_step_loop_and_jax_lr(tmp_path):
    opts = ("TRAINER.MAX_EPOCHS", "2", "OPTIMIZER.WARMUP_EPOCHS", "1",
            "CALLBACK.SAVE_TOP_K", "1", "TPU.PROFILE_STEPS", "1")
    cfg, jcfg = smoke_cfg(tmp_path, *opts, jax_too=True)
    trainer = Trainer(cfg)
    train_loader, val_loader = build_loaders(cfg)
    trainer.fit(train_loader, val_loader)
    rows = read_metrics(trainer)
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert trainer.global_step == 4 and train_loader.epoch == 2
    assert len(read_metrics(trainer, "val/metrics")) == 2
    assert os.path.exists(os.path.join(trainer.workdir, "profile",
                                       "trace.json"))

    # the same steps by hand
    model = build_model(ModelConfig.from_cfg(cfg), seed=int(cfg.SEED),
                        device="cpu")
    schedule = lr_schedule_from_cfg(cfg, steps_per_epoch=2)
    opt = make_optimizer(model, lr=schedule(0))
    gen = torch.Generator().manual_seed(int(cfg.SEED) + 17)
    loader, _ = build_loaders(cfg)
    losses = []
    for step, batch in enumerate(b for _ in range(2) for b in loader):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        m = train_step(model.train(), opt, to_device_batch(batch, "cpu"),
                       gen, trainer.loss_cfg,
                       float(cfg.TRAINER.GRADIENT_CLIP_VAL))
        losses.append(float(m["total_loss"]))
    assert [r["total_loss"] for r in rows] == losses

    want_lr = j_build_lr(jcfg, steps_per_epoch=2)
    lrs = [r["lr"] for r in rows]
    np.testing.assert_allclose(lrs, [float(want_lr(s)) for s in range(4)],
                               rtol=1e-7, atol=0)
    assert lrs[0] < lrs[2]            # warm-up over the first epoch


def test_accumulate_two_equals_one_step_on_mean_gradient(tmp_path):
    cfg = smoke_cfg(tmp_path, "MODEL.DECODER.TRANSFORMER.DROPOUT_RATE", "0.0")
    mcfg = ModelConfig.from_cfg(cfg)
    batches = [to_device_batch(make_batch([2 * i, 2 * i + 1]), "cpu")
               for i in range(2)]
    a, b = (build_model(mcfg, seed=3, device="cpu").train()
            for _ in range(2))
    opt_a, opt_b = make_optimizer(a, lr=1e-3), make_optimizer(b, lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    for i, batch in enumerate(batches):
        m = train_step(a, opt_a, batch, gen, accumulate=2, micro_step=i)
        assert ("grad_norm" in m) == (i == 1)
    gen = torch.Generator().manual_seed(0)
    grads = []
    for batch in batches:
        opt_b.zero_grad(set_to_none=True)
        losses, _ = forward_and_loss(b, batch, gen)
        losses["total_loss"].backward()
        grads.append([p.grad.clone() for p in b.parameters()])
    for p, g0, g1 in zip(b.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    clip_by_global_norm_(list(b.parameters()), 1.0)
    opt_b.step()
    assert opt_a.state_dict()["state"][0]["step"] == 1
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-6, atol=1e-7, msg=n)


@pytest.mark.parametrize("limit, n, want", [
    (1.0, 4, 4), (0.5, 4, 2), (0.01, 4, 1), (0.0, 4, 0), (0, 4, 0),
    (2, 4, 2), (3.0, 4, 3)])
def test_val_batch_limit_lightning_table(limit, n, want):
    assert val_batch_limit(limit, n) == want


def test_limit_val_batches_in_validate(tmp_path):
    """0.0 runs no batch; a small fraction runs one; two limited runs score
    the same subset (tests/test_trainer_loop.py:140-187)."""
    cfg = smoke_cfg(tmp_path)
    val = SnippetLoader(SyntheticDataset(8, seed=100), 2, shuffle=False,
                        drop_last=False)
    trainer = Trainer(cfg)
    trainer.setup_state(steps_per_epoch=1)
    assert trainer.validate(val, limit_batches=0.0) == {}
    assert "total_loss" in trainer.validate(val, limit_batches=0.01)
    m1 = trainer.validate(val, limit_batches=2)
    m2 = trainer.validate(val, limit_batches=2)
    assert m1["total_loss"] == m2["total_loss"]


def test_resume_continues_at_saved_step(tmp_path):
    cfg = smoke_cfg(tmp_path, "CALLBACK.SAVE_TOP_K", "1")
    first = Trainer(cfg)
    loader, val = build_loaders(cfg)
    first.fit(loader, val)
    assert first.ckpt_mgr.latest_step() == 2
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}

    cfg2 = smoke_cfg(tmp_path, "CALLBACK.SAVE_TOP_K", "1",
                     "TRAINER.MAX_EPOCHS", "2")
    second = Trainer(cfg2)
    loader2, val2 = build_loaders(cfg2)
    second.setup_state(len(loader2))
    assert second.restore_if_available(loader2)
    assert second.global_step == 2
    assert loader2.state_dict() == {"epoch": 0, "position": 2, "seed": 100}
    for k, v in saved.items():
        assert torch.equal(second.model.state_dict()[k], v), k
    second.fit(loader2, val2)
    assert second.global_step == 4 and loader2.epoch == 2
    assert [r["step"] for r in read_metrics(second)][-2:] == [3, 4]
    assert second.ckpt_mgr.latest_step() == 4


def test_device_batch_keys_and_dtypes():
    batch = to_device_batch(make_batch([0]), "cpu")
    assert sorted(batch) == sorted(DEVICE_KEYS)
    assert batch["sym"].dtype == torch.int32
    assert batch["rgb_img"].dtype == torch.float32

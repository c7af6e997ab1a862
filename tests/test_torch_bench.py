"""`python -m parq_torch.bench`, the port's twin of bench.py, on the CPU at
tiny width: its JSON line's keys, a positive rate, the eval accumulator
equal to the sum of every output leaf, the train loop's generator
threading, the synthetic batch equal to the JAX package's, the FLOP count
behind the plausibility guard against torch's FLOP counter, and the flags
it refuses."""
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from parq_torch import bench
from parq_torch.config import ModelConfig
from parq_torch.models import BATCH_KEYS

import torch_common  # noqa: F401

TINY = ModelConfig.tiny()
KEYS = {"metric", "value", "unit", "device", "host_cpu", "device_busy_ms",
        "wall_ms", "launches_per_iter"}


def test_eval_line_and_accumulator():
    fwd, batch = bench.build(2, "float32", seed=3, device="cpu", cfg=TINY)
    rate = bench.measure(fwd, batch, iters=1, warmup=1)
    want = sum(float(v.double().sum()) for v in fwd(batch).values())
    assert rate.fps > 0 and rate.wall_ms > 0
    assert float(rate.acc) == pytest.approx(want, rel=1e-5)
    assert rate.launches == {}      # the plain versions launch no kernel

    out = bench.run(bench.parse_args(["--batch", "2", "--iters", "2"]),
                    TINY, "cpu")
    assert set(out) == KEYS | {"vs_baseline"}
    assert out["metric"] == "multi_view_frames_per_sec_per_chip"
    assert out["unit"] == "frames/sec/chip" and out["value"] > 0
    # value is round(fps, 2) and vs_baseline round(fps / reference, 1),
    # both from the unrounded rate: they differ from each other by at most
    # the two roundings' halves.
    ref = bench.CPU_REFERENCE_FPS
    assert out["vs_baseline"] == round(out["vs_baseline"], 1)
    assert (abs(out["vs_baseline"] - out["value"] / ref)
            <= 0.05 + 0.005 / ref + 1e-9)
    assert out["device"] == "cpu" and out["device_busy_ms"] is None
    assert out["host_cpu"]
    json.loads(json.dumps(out))


def test_train_line_and_generator_threading():
    step, batch, gen = bench.build_train(2, "float32", dropout_rate=0.2,
                                         seed=4, device="cpu", cfg=TINY)
    rate = bench.measure_train(step, batch, gen, iters=2, warmup=1)
    assert rate.fps > 0 and torch.isfinite(rate.acc)
    # the same seed replays the same losses: the warm-up step, then the
    # two timed ones, each on the one generator
    step2, batch2, gen2 = bench.build_train(2, "float32", dropout_rate=0.2,
                                            seed=4, device="cpu", cfg=TINY)
    losses = [float(step2(batch2, gen2)["total_loss"]) for _ in range(3)]
    assert float(rate.acc) == pytest.approx(sum(losses[1:]), rel=1e-5)
    assert losses[1] != losses[2]

    out = bench.run(bench.parse_args(["--train", "--batch", "2", "--iters",
                                      "1", "--dropout", "0.0"]), TINY, "cpu")
    assert set(out) == KEYS | {"dropout_override"}
    assert out["metric"] == "train_frames_per_sec_per_chip"
    assert out["value"] > 0 and out["dropout_override"] == 0.0


def test_batch_equals_the_jax_batch():
    from parq_tpu.data.synthetic import device_batch, make_batch
    want = device_batch(make_batch(list(range(3)), image_size=(64, 48)))
    got = bench.bench_batch(TINY, 3, "cpu", bench.TRAIN_KEYS)
    assert sorted(got) == sorted(BATCH_KEYS + ("obbs_padded", "sym"))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k],
                                                            np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("cfg", [
    TINY, ModelConfig(image_size=(64, 48), num_queries=16, dec_layers=2)],
    ids=["tiny", "release-width"])
def test_flops_match_torch_counter(cfg):
    """Every product but the cross-attention's is counted by torch's
    counter; the cross-attention runs inside the custom op
    `parq::flash_kv_fused`, which the counter does not enter."""
    fwd, batch = bench.build(1, "float32", seed=0, device="cpu", cfg=cfg)
    with FlopCounterMode(display=False) as counter:
        fwd(batch)
    parts = bench.forward_flops(cfg)
    assert counter.get_total_flops() == \
        sum(parts.values()) - parts["cross_attention"]
    T, (w, h) = cfg.num_views, cfg.feat_size
    assert parts["cross_attention"] == (cfg.dec_layers * 2 * 2
                                        * cfg.num_queries * T * h * w
                                        * cfg.dec_dim)


def test_guard():
    release = ModelConfig()
    per_frame = sum(bench.forward_flops(release).values()) / 3
    assert 100e9 < per_frame < 125e9
    assert bench.guard_fps(release) == pytest.approx(989e12 / per_frame)
    assert bench.guard_fps(release, train=True) == pytest.approx(
        bench.guard_fps(release) / 2)
    bench._check_guard(0.99 * bench.guard_fps(release), release, False)
    with pytest.raises(RuntimeError, match="non-physical"):
        bench._check_guard(1.01 * bench.guard_fps(release), release, False)


def test_no_pallas_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--no-pallas"])
    assert e.value.code == 2
    assert "--no-pallas is not ported" in capsys.readouterr().err
    assert bench.parse_args(["--pallas"]).pallas      # a no-op, accepted


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the exit without a GPU")
def test_exits_2_without_a_gpu(capsys):
    assert bench.main([]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device is visible" in err


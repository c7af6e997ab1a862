"""The port's recorder (`parq_torch.telemetry`) on the CPU: spans with
their parents, batch ids and aggregates, the first and the newest events
kept, the counters, `enable(False)`, spans as profiler ranges, what `parse_pred`,
the model's construction and the Trainer record, and the launch counts of
replayed graphs. Its device marks need a card: tests/test_torch_cuda.py."""
import argparse
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from parq_torch import telemetry
from parq_torch.evals import parse_pred
from parq_torch.kernels import (KERNELS, GraphLaunches, launch_counts,
                                reset_launch_counts)
from parq_torch.telemetry import Recorder

import torch_common  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rec():
    """The process's recorder, emptied and on; left on."""
    telemetry.reset()
    telemetry.enable(True)
    yield telemetry.RECORDER
    telemetry.enable(True)


def spans_of(ring, name):
    return [e for e in ring if e["kind"] == "span" and e["name"] == name]


def test_spans_nest_and_share_their_batch():
    r = Recorder()
    with r.span("outer"):
        with r.span("inner"):
            pass
        with r.span("inner"):
            pass
    first = r.next_batch()
    with r.span("after"):
        pass
    second = r.next_batch()
    assert second == first + 1
    snap = r.snapshot()
    ring = snap["ring"]
    assert [e["name"] for e in ring] == ["inner", "inner", "outer", "after"]
    assert [e["parent"] for e in ring] == ["outer", "outer", None, None]
    assert [e["batch"] for e in ring] == [0, 0, 0, first]
    outer, inner = ring[2], ring[0]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]
    assert not any(e["profiled"] for e in ring)
    agg = snap["spans"]
    assert agg["inner"]["count"] == 2 and agg["outer"]["count"] == 1
    durations = [(e["end_ns"] - e["start_ns"]) / 1e9
                 for e in spans_of(ring, "inner")]
    assert agg["inner"]["total_s"] == pytest.approx(sum(durations))
    assert agg["inner"]["max_s"] == pytest.approx(max(durations))
    assert agg["inner"]["self_s"] == agg["inner"]["total_s"]
    assert agg["outer"]["self_s"] == pytest.approx(
        agg["outer"]["total_s"] - agg["inner"]["total_s"])


def test_a_span_closed_by_an_exception_is_recorded_and_unwound():
    r = Recorder()
    with pytest.raises(ValueError):
        with r.span("fails"):
            raise ValueError
    with r.span("next"):
        pass
    ring = r.snapshot()["ring"]
    assert [e["name"] for e in ring] == ["fails", "next"]
    assert ring[1]["parent"] is None


def test_batch_ids_are_per_thread():
    r = Recorder()
    mine = r.next_batch()
    seen = []
    t = threading.Thread(target=lambda: seen.append((r.batch(),
                                                     r.next_batch())))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen[0][0] == 0 and seen[0][1] not in (0, mine)
    assert r.batch() == mine


def test_the_ring_keeps_the_newest_events(monkeypatch):
    """The head keeps the first events, the ring the newest after them,
    and the snapshot says how many fell out between the two and where."""
    monkeypatch.setattr(telemetry, "HEAD", 3)
    monkeypatch.setattr(telemetry, "RING", 5)
    r = Recorder()
    for i in range(7):
        with r.span(f"s{i}"):
            pass
    snap = r.snapshot()
    assert [e["name"] for e in snap["ring"]] == [f"s{i}" for i in range(7)]
    assert snap["dropped"] == 0 and snap["dropped_at"] is None
    for i in range(7, 12):
        with r.span(f"s{i}"):
            pass
    snap = r.snapshot()
    assert [e["name"] for e in snap["ring"]] == [
        "s0", "s1", "s2"] + [f"s{i}" for i in range(7, 12)]
    assert snap["dropped"] == 4 and snap["dropped_at"] == 3
    assert len(snap["spans"]) == 12             # the aggregates keep all


def test_counters_add_and_carry_the_launch_counts():
    r = Recorder()
    r.count("a")
    r.count("a", 4)
    r.count("b", 2.5)
    r.count_later(lambda: {"a": 1, "c": 7})
    counters = r.snapshot()["counters"]
    assert counters["a"] == 6 and counters["b"] == 2.5 and counters["c"] == 7
    for name, n in launch_counts().items():
        assert counters[f"kernels.{name}.launches"] == n


def test_off_records_nothing():
    r = Recorder()
    r.enable(False)
    with r.span("x"):
        r.count("c")
        r.mark("m")
        r.anchor()
    assert r.next_batch() == 0
    snap = r.snapshot()
    assert snap["enabled"] is False
    assert snap["spans"] == {} and snap["ring"] == []
    assert not any(k for k in snap["counters"] if not k.startswith("kernels"))
    assert snap["marks"]["made"] == 0
    r.enable(True)
    with r.span("x"):
        pass
    assert r.snapshot()["spans"]["x"]["count"] == 1


def test_marks_need_a_card():
    r = Recorder()
    r.mark("m")
    r.anchor()
    r.resolve()
    assert r.snapshot()["marks"] == {"made": 0, "placed": 0, "dropped": 0,
                                     "placed_before_enqueue": 0}


def test_counters_and_spans_lose_nothing_across_threads(monkeypatch):
    """More threads than cores, a short switch interval: every count and
    span of every thread arrives."""
    monkeypatch.setattr(telemetry, "HEAD", 64)
    monkeypatch.setattr(telemetry, "RING", 64)
    r = Recorder()
    n_threads, n = 4 * (os.cpu_count() or 1), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with r.span("t"):
                    r.count("c")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = r.snapshot()
    assert snap["counters"]["c"] == n_threads * n
    assert snap["spans"]["t"]["count"] == n_threads * n
    assert all(e["parent"] is None for e in snap["ring"])


def test_spans_are_profiler_ranges_of_their_names(rec):
    from torch.profiler import ProfilerActivity, profile
    with telemetry.span("before.profile"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("layer.outer"):
            with telemetry.span("layer.inner"):
                torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("layer.outer") == 1 and names.count("layer.inner") == 1
    assert "before.profile" not in names
    ring = telemetry.snapshot()["ring"]
    assert [e["profiled"] for e in ring] == [False, True, True]


def test_a_span_steps_through_sibling_phases(rec):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("outer"):
            with telemetry.span("phase.a") as phase:
                phase.next("phase.b")
                with telemetry.span("inner"):
                    pass
                phase.next("phase.c")
    names = [e.name for e in prof.events()]
    for n in ("phase.a", "phase.b", "phase.c", "inner"):
        assert names.count(n) == 1, n
    snap = telemetry.snapshot()
    ring = {e["name"]: e for e in snap["ring"]}
    assert [e["name"] for e in snap["ring"]] == ["phase.a", "inner",
                                                 "phase.b", "phase.c",
                                                 "outer"]
    assert {ring[n]["parent"] for n in ("phase.a", "phase.b",
                                        "phase.c")} == {"outer"}
    assert ring["inner"]["parent"] == "phase.b"
    assert ring["phase.a"]["end_ns"] <= ring["phase.b"]["start_ns"] \
        <= ring["phase.b"]["end_ns"] <= ring["phase.c"]["start_ns"]
    agg = snap["spans"]
    assert agg["phase.b"]["self_s"] == pytest.approx(
        agg["phase.b"]["total_s"] - agg["inner"]["total_s"])
    assert agg["outer"]["self_s"] == pytest.approx(
        agg["outer"]["total_s"] - sum(agg[n]["total_s"] for n in (
            "phase.a", "phase.b", "phase.c")))


def _outputs(B=2, K=32, seed=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, K, 10).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    out = {"size_unnormalized": rng.rand(B, K, 3) + 0.3,
           "center_unnormalized": rng.randn(B, K, 3) * 0.8 + [0, 0, 1],
           "sem_cls_prob": probs, "ortho6d": rng.randn(B, K, 6)}
    Twl = np.tile(np.concatenate([np.eye(3).reshape(9), [0.3, -0.2, 0.1]]),
                  (B, 1, 1))
    return ({k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()},
            torch.tensor(Twl, dtype=torch.float32))


@pytest.mark.parametrize("enable_nms", [True, False])
def test_parse_pred_records_its_halves(rec, enable_nms):
    track = (-1.5, 1.5, -2.0, 1.0, 0.0, 2.0)
    hosts = []
    for seed in (3, 4, 5):
        out, Twl = _outputs(seed=seed)
        telemetry.next_batch()
        hosts.append(parse_pred(out, Twl, track, 9, enable_nms=enable_nms))
    snap = telemetry.snapshot()
    agg, counters = snap["spans"], snap["counters"]
    assert agg["parse_pred.device"]["count"] == 3
    assert agg["parse_pred.to_host"]["count"] == 3
    assert agg.get("parse_pred.nms", {"count": 0})["count"] == \
        (3 if enable_nms else 0)
    assert "parse_pred.d2h_copies" not in counters   # CPU: nothing copied
    assert counters["parse_pred.kept"] == sum(int(h["pred_mask"].sum())
                                              for h in hosts)
    assert counters.get("parse_pred.nms_boxes", 0) == (
        sum(int((h["labels"] != 9).sum()) for h in hosts)
        if enable_nms else 0)
    assert 0 < counters["parse_pred.kept"]
    batches = {e["batch"] for e in snap["ring"] if e["kind"] == "span"}
    assert len(batches) == 3 and 0 not in batches
    assert snap["marks"]["made"] == 0           # no card: no marks


def test_model_init_is_a_span(rec):
    from parq_torch.config import ModelConfig
    from parq_torch.models import build_model
    build_model(ModelConfig.tiny(), seed=0, device="cpu")
    spans = telemetry.spans("models.")
    assert spans["models.init"]["count"] == 1
    assert spans["models.init"]["total_s"] > 0


def test_the_custom_ops_first_call_imports_dynamo_in_a_span(rec,
                                                            monkeypatch):
    """The import that a custom op's first call brings is the span
    kernels.dynamo_import, once, inside the span that made the call."""
    from parq_torch.kernels import _build
    from parq_torch.kernels.pixel_align import sample_views
    monkeypatch.setattr(_build, "_dynamo_imported", False)
    with telemetry.span("caller"):
        for _ in range(2):
            sample_views(torch.randn(1, 2, 4, 4, 8), torch.rand(1, 2, 5, 4))
    spans = telemetry.spans()
    assert spans["kernels.dynamo_import"]["count"] == 1
    ring = telemetry.snapshot()["ring"]
    assert spans_of(ring, "kernels.dynamo_import")[0]["parent"] == "caller"


def test_graphed_calls_open_batches_on_the_cpu(rec):
    from parq_torch.graphs import Graphed
    f = Graphed(lambda x: x + 1)
    b0 = telemetry.RECORDER.batch()
    f(torch.zeros(2))
    f(torch.zeros(2))
    assert telemetry.RECORDER.batch() == b0 + 2
    assert telemetry.spans("graphs.") == {}     # eager: nothing captured


def test_replayed_launches_count_until_reset_and_survive_the_graph():
    """A graph's launches count replays × its launches, are zeroed by
    `reset_launch_counts` and move into the wrappers' counters when the
    graph is dropped, as eager launches would have counted."""
    reset_launch_counts()
    name = next(iter(KERNELS))
    g = GraphLaunches({name: 3})
    g.replays += 2
    assert launch_counts()[name] == 6
    reset_launch_counts()
    assert launch_counts()[name] == 0
    g.replays += 1
    g.fold()
    assert KERNELS[name].launches == 3 and launch_counts()[name] == 3
    g.fold()                                      # a second fold adds 0
    assert launch_counts()[name] == 3
    reset_launch_counts()


def test_device_profile_busy_is_a_union():
    from parq_torch.tools.profiling import union_ms
    assert union_ms([(0.0, 10.0), (5.0, 15.0), (20.0, 30.0),
                     (25.0, 26.0)]) == pytest.approx(0.025)
    assert union_ms([(3.0, 4.0), (0.0, 1.0)]) == pytest.approx(0.002)
    assert union_ms([]) == 0.0


LINE = re.compile(r"^(\w+) +(\d+\.\d\d) +(\d+) +(\d+\.\d\d)$")


def test_trainer_phases_are_recorder_spans(rec, tmp_path):
    """The 'simple' profiler's phases are trainer.<phase> spans; its table
    keeps its text, counts only this Trainer's, and the spans lie in the
    PROFILE_STEPS trace as ranges of their names."""
    from parq_torch.cli.train import build_loaders
    from parq_torch.config import get_cfg, update_config
    from parq_torch.train.loop import Trainer
    cfg = get_cfg()
    update_config(cfg, argparse.Namespace(
        cfg=os.path.join(ROOT, "configs", "smoke.yaml"),
        opts=["TPU.PLATFORM", "cpu", "LOG_PATH", str(tmp_path),
              "TRAINER.MAX_EPOCHS", "1", "TPU.PROFILE_STEPS", "1"]))
    trainer = Trainer(cfg)
    train_loader, val_loader = build_loaders(cfg)
    trainer.fit(train_loader, val_loader)
    text = trainer.profile_summary().splitlines()
    assert text[0] == "phase            total_s    calls    mean_ms"
    rows = {m.group(1): (float(m.group(2)), int(m.group(3)))
            for m in map(LINE.match, text[1:])}
    assert len(rows) == len(text) - 1
    assert {"data", "train_step", "validate", "checkpoint", "val_data",
            "val_step", "val_host"} <= set(rows)
    assert set(rows) <= {"data", "train_step", "log_images", "log",
                         "validate", "checkpoint", "val_data", "val_step",
                         "val_host"}
    assert rows["train_step"][1] == trainer.global_step
    assert rows["validate"][0] >= rows["val_step"][0]
    assert Trainer(cfg).profile_summary().splitlines() == text[:1]
    with open(os.path.join(trainer.workdir, "profile", "trace.json")) as f:
        trace = f.read()
    assert '"trainer.' in trace

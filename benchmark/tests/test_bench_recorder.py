"""The per-layer metrics that read the program's recorder, on the tiny
CPU cell: a traced run reads the NMS spans and the model's construction,
and gives no value for the metrics of device marks (no card, no mark),
for the capture (the CPU runs eagerly) nor for the copies to the host
(none on the CPU); a program without a recorder gives every such metric
no value, and no error. The readers take the batches before the first
profiled one, and never batches after events that fell out of the
recorder's ring."""
import sys

import torch

from benchmark import recorder
from benchmark.run import run_cell
from benchmark.tests.tiny import make_root

RECORDER_METRICS = ("eval_fwd_mfu.replay", "post_fwd_ms.eval",
                    "host_gap_ms.eval", "nms_ms.eval", "capture_s.eval",
                    "model_init_s.eval", "d2h_copies.eval")


def traced(tmp_path):
    from parq_torch import telemetry
    telemetry.reset()
    root = make_root(tmp_path)
    out, _ = run_cell(root, "tiny-eval", 2 ** 31 + 11, 1.0, True,
                      torch.device("cpu"), 0.0)
    return out


def test_a_traced_cpu_run_reads_the_recorders_spans(tmp_path):
    out = traced(tmp_path)
    got = out["metrics"]
    assert out["correct"]
    assert got["nms_ms.eval"]["unit"] == "ms"
    assert 0 < got["nms_ms.eval"]["value"] < 1e3
    assert got["model_init_s.eval"]["unit"] == "s"
    assert 0 < got["model_init_s.eval"]["value"] < 60
    for name in ("eval_fwd_mfu.replay", "post_fwd_ms.eval",
                 "host_gap_ms.eval", "capture_s.eval", "d2h_copies.eval"):
        assert name not in got, name


def test_a_program_without_a_recorder_reads_nothing(tmp_path, monkeypatch):
    import parq_torch
    monkeypatch.setitem(sys.modules, "parq_torch.telemetry", None)
    monkeypatch.delattr(parq_torch, "telemetry")
    root = make_root(tmp_path)
    out, _ = run_cell(root, "tiny-eval", 5, 1.0, True, torch.device("cpu"),
                      0.0)
    assert out["correct"]
    assert not set(RECORDER_METRICS) & set(out["metrics"])
    assert "idle_share.eval" in out["metrics"]


class _Run:
    def __init__(self, snap):
        self._recorder_snapshot = snap


def _span(batch, profiled):
    return {"kind": "span", "name": "parse_pred.nms", "start_ns": 0,
            "end_ns": 1_000_000 * batch, "parent": None, "batch": batch,
            "profiled": profiled}


def test_the_readers_take_only_batches_before_the_profiled_stretch():
    before = [_span(b, False) for b in (1, 2, 3)]
    stretch = [_span(b, True) for b in (4, 5)]
    after = [_span(b, False) for b in (6, 7)]
    whole = {"ring": before + stretch + after, "dropped": 0,
             "dropped_at": None}
    assert recorder.span_ms(_Run(whole), "parse_pred.nms") == [1, 2, 3]
    # the profiled stretch fell out of the ring: the head is still before
    # it, and what follows the gap is not read
    gap = {"ring": before + after, "dropped": 40, "dropped_at": 3}
    assert recorder.span_ms(_Run(gap), "parse_pred.nms") == [1, 2, 3]
    # the stretch began inside the head
    early = {"ring": before[:2] + stretch + after, "dropped": 9,
             "dropped_at": 4}
    assert recorder.span_ms(_Run(early), "parse_pred.nms") == [1, 2]

"""BENCHMARK.json against the contract's shape; the harness finds cells,
loops and metrics by name and refuses an unknown one; a new cell, loop
kind and metric are new files and entries only; the last line's shape."""
import json
import re

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from benchmark.tests.tiny import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = harness.find_cell(REPO, w["name"])
        assert cell.per_layer() and len(cell.end_to_end()) >= 2
        assert cell.loop() is not None
        for m in cell.per_layer():
            assert hasattr(cell.reader(m["name"]), "read")
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(harness.BenchError):
        harness.find_cell(REPO, "no-such-cell")
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ghost", "config": "tiny",
                               "traffic": "no-such-traffic", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(harness.BenchError):
        harness.find_cell(root, "ghost")
    cell = harness.find_cell(root, "tiny-eval")
    with pytest.raises(harness.BenchError):
        cell.reader("no_such_metric")


NOOP_LOOP = '''
from benchmark.harness import Run
from benchmark.trace import Stretch


def run(ctx):
    with Stretch(ctx.device, ctx.trace) as s:
        pass
    return Run(attempted=3, failed=0,
               metrics={"noop_per_s": 7.0, "setup_s": 0.5},
               checks={"same": (0.0, float(ctx.limits["same"]))},
               memory_peak_bytes=0, trace=s if ctx.trace else None,
               counts={"calls": 3.0})
'''

NOOP_METRIC = '''
def read(cell, run):
    return run.counts["calls"] * cell.traffic["scale"]
'''


def test_a_cell_loop_and_metric_are_only_new_files(tmp_path):
    root = make_root(tmp_path)
    d = root / "benchmark"
    (d / "loops" / "noop.py").write_text(NOOP_LOOP)
    (d / "metrics" / "noop_calls.py").write_text(NOOP_METRIC)
    (d / "traffic" / "noop-mix.json").write_text(
        json.dumps({"loop": "noop", "scale": 2.0}))
    (d / "limits" / "noop-tiny.json").write_text(json.dumps({"same": 0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "noop-tiny", "config": "tiny",
                               "traffic": "noop-mix", "chips": 1,
                               "why": "a dummy cell"})
    bench["end_to_end"].append({"name": "noop_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["noop-tiny"]})
    bench["per_layer"].append({"name": "noop_calls", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "noop", "moves": "noop_per_s",
                               "workloads": ["noop-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, _ = run_cell(root, "noop-tiny", 1, 1.0, False, torch.device("cpu"),
                      0.0)
    assert out["metrics"] == {"noop_per_s": {"value": 7.0,
                                             "unit": "calls/s"},
                              "setup_s": {"value": 0.5, "unit": "s"}}
    out, _ = run_cell(root, "noop-tiny", 1, 1.0, True, torch.device("cpu"),
                      0.0)
    assert out["metrics"] == {"noop_calls": {"value": 6.0,
                                             "unit": "calls"}}
    assert out["correct"] and list(out)[-1] == "checks"


def test_last_line_shape(tmp_path):
    root = make_root(tmp_path)
    out, run = run_cell(root, "tiny-eval", 2 ** 31 + 7, 1.0, False,
                        torch.device("cpu"), harness.process_start())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["metrics"]["setup_s"]["value"] > 0
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    json.dumps(out, allow_nan=False)
    assert harness.check_lines(run)[0].startswith("check ")
